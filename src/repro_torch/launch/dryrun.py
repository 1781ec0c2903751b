"""Dry-run: count every (arch × shape × mesh) cell, or plan transfers.

Without ``--comm`` the driver sweeps the model cells: for every registered
arch × :data:`~repro_torch.configs.shapes.SHAPES` × the single-pod
(16×16) and multi-pod (2×16×16) production meshes, skipping what
:func:`~repro_torch.configs.shapes.skip_reason` skips, it

1. builds :func:`~repro_torch.launch.specs.input_specs` (meta tensors and
   their specs, no allocation),
2. counts one call of the cell's step on them under the ambient mesh
   (:mod:`repro_torch.launch.cost`: FLOPs, HBM bytes, collective records,
   peak live bytes) at full depth — the peak is the row's temporary
   bytes — and by **loop extrapolation** from L=0 and L=1 probes, as the
   reference does for its compiler's loop-blind cost analysis:
   ``total = cost(L0) + Σ_bodies n_i · (cost(L1ᵢ) − cost(L0))`` — gemma3's
   local/global stack uses two body probes. The port's layer loop is
   Python, so the two agree exactly; the probes are what a card that holds
   one layer of a large model can run and measure,
3. writes the reference's row, key for key, with the roofline terms at the
   H100's data-sheet peaks (:mod:`repro_torch.launch.roofline`), plus a
   ``note`` on what the count covers (:data:`NOTE`).

Per device: the device-stacked program does every device's work on one
device, so a row's FLOPs, HBM bytes and temporary bytes are the counted
totals over ``chips`` (the even split the specs lay out); its argument
and output bytes are each leaf's bytes over the product of the axes its
spec names; its collectives are those the program issues (the expert-
parallel MoE's combine psum and its FSDP weight gather), each record's
wire bytes summed over the rows it runs on, over ``chips``. Nothing runs
on a device: a count on meta tensors is Python dispatch only.

``--comm`` runs :func:`run_comm_dryrun` instead: ``session.describe(...)``
over the standard topologies (copy-node/edge counts, critical-path depth,
modeled times), a schedule sweep over the shipped chunk-interleaving
passes and, with ``--fail-link SRC:DST``, before/after re-plan rows with
that link down. Sessions are built on the CPU and nothing is launched.
``repro_torch.launch.report`` renders both row kinds.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a]
        [--shape s] [--mesh single|multi|both] [--out f.json]
        [--skip-existing]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --comm \\
        [--fail-link SRC:DST] [--out f.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

#: What a model cell's row counts, beside its numbers.
NOTE = ("counted on meta tensors: matmul-class and kernel FLOPs, the "
        "unfused eager program's HBM bytes (each op's inputs read and "
        "outputs written once), which a captured replay repeats; "
        "collectives are those the device-stacked program issues (the "
        "MoE combine psum and FSDP weight gather) — the dense "
        "tensor-parallel psums and logits gather run only across a peer "
        "mesh's cards in serving, and the data-axis gradient reduction is "
        "not issued, so neither is counted here; the collective term is "
        "modeled at one NVLink 4 link, not measured")


def _wire_rows(op: str, result_bytes: int, n: int) -> int:
    """A record's wire bytes summed over its ``n`` rows: the per-device
    ring multiplier times ``n``, an integer for every op kind."""
    from repro_torch.launch import roofline
    return round(result_bytes * roofline._wire_multiplier(op, n) * n)


def _cost_tuple(counted):
    """(flops, hbm bytes, wire bytes, by_op) of a count, summed over the
    rows: every number an integer, so probes extrapolate exactly."""
    by_op: dict = {}
    wire = 0
    for op, rb, n in counted.collectives:
        w = _wire_rows(op, rb, n)
        wire += w
        d = by_op.setdefault(op, {"count": 0, "wire_bytes": 0})
        d["count"] += n
        d["wire_bytes"] += w
    return counted.flops, counted.bytes, wire, by_op


def _merge_by_op(base, body, n):
    out = {k: dict(v) for k, v in base.items()}
    for k, v in body.items():
        d = out.setdefault(k, {"count": 0, "wire_bytes": 0.0})
        d["count"] += n * v["count"]
        d["wire_bytes"] += n * v["wire_bytes"]
    return out


def lower_and_compile(arch, shape, mesh):
    """Build the cell and count one call of its step on meta tensors under
    the ambient ``mesh``: ``(cell, (outputs, Cost))``."""
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.specs import input_specs
    cell = input_specs(arch, shape, mesh)
    with set_mesh(mesh):
        counted = cost.count(cell.fn, *cell.abstract_args)
    return cell, counted


def body_probes(arch):
    """[(count, probe_cfg)] covering the layer stack's body types."""
    if arch.attention == "local_global":
        r = arch.local_global_ratio
        n_global = sum(1 for i in range(arch.num_layers) if i % (r + 1) == r)
        n_local = arch.num_layers - n_global
        local = dataclasses.replace(arch, num_layers=1)
        glob = dataclasses.replace(arch, num_layers=1, attention="full",
                                   local_global_ratio=0, window=None)
        return [(n_local, local), (n_global, glob)]
    return [(arch.num_layers, dataclasses.replace(arch, num_layers=1))]


def extrapolated_cost(arch, shape, mesh):
    """(flops, hbm_bytes, wire_bytes, by_op) summed over the devices,
    loop-extrapolated from the L=0 and L=1 probes."""
    base_cfg = dataclasses.replace(arch, num_layers=0)
    _, (_, c0) = lower_and_compile(base_cfg, shape, mesh)
    f0, b0, w0, op0 = _cost_tuple(c0)
    flops, bytes_, wire, by_op = f0, b0, w0, {k: dict(v)
                                              for k, v in op0.items()}
    for count, probe_cfg in body_probes(arch):
        _, (_, c1) = lower_and_compile(probe_cfg, shape, mesh)
        f1, b1, w1, op1 = _cost_tuple(c1)
        flops += count * max(0, f1 - f0)
        bytes_ += count * max(0, b1 - b0)
        wire += count * max(0, w1 - w0)
        body_ops = {k: {"count": v["count"] - op0.get(k, {}).get("count", 0),
                        "wire_bytes": v["wire_bytes"] -
                        op0.get(k, {}).get("wire_bytes", 0)}
                    for k, v in op1.items()}
        by_op = _merge_by_op(by_op, body_ops, count)
    return flops, bytes_, wire, by_op


def run_cell(arch, shape, mesh, mesh_name):
    from repro_torch.launch import roofline
    from repro_torch.launch.specs import leaf_specs, shard_bytes, tree_bytes

    cell, (outputs, full) = lower_and_compile(arch, shape, mesh)
    flops, hbm, wire, by_op = extrapolated_cost(arch, shape, mesh)
    chips = mesh.size
    flops, hbm, wire = flops / chips, hbm / chips, wire / chips
    by_op = {k: {"count": v["count"] / chips,
                 "wire_bytes": v["wire_bytes"] / chips}
             for k, v in by_op.items()}
    tokens = shape.global_batch * shape.seq_len
    nap = arch.active_param_count()
    if shape.kind == "train":
        mflops = roofline.train_model_flops(nap, tokens)
    elif shape.kind == "prefill":
        mflops = roofline.prefill_model_flops(nap, tokens)
    else:
        mflops = roofline.decode_model_flops(nap, shape.global_batch)
    argument = tree_bytes(cell.abstract_args, cell.specs, mesh)
    output = tree_bytes(outputs, cell.out_specs, mesh)
    # a decode step updates its cache in place: outputs that are arguments
    held = {t.untyped_storage()._cdata
            for t, _ in leaf_specs(cell.abstract_args, cell.specs)}
    alias = sum(shard_bytes(t, s, mesh)
                for t, s in leaf_specs(outputs, cell.out_specs)
                if t.untyped_storage()._cdata in held)
    temp = full.peak_bytes / chips
    terms, bottleneck = roofline.roofline_terms(flops, hbm, wire)
    row = {
        "arch": arch.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "kind": shape.kind, "chips": chips,
        "description": cell.description,
        "flops": flops, "hbm_bytes": hbm, "wire_bytes": wire,
        "collective_by_op": by_op,
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": terms["collective"], "bottleneck": bottleneck,
        "model_flops": mflops,
        "useful_flops_ratio": (mflops / (flops * chips)
                               if flops else 0.0),
        "memory_per_device_gb": (argument + output - alias + temp) / 2**30,
        "argument_gb": argument / 2**30,
        "output_gb": output / 2**30,
        "temp_gb": temp / 2**30,
        "alias_gb": alias / 2**30,
    }
    return row


def _comm_topologies():
    """(name, topology, (src, dst)) sweep cells; the hierarchical cell
    describes a cross-island transfer so the staged-routing and
    flat-vs-two-level model rows land in the dry-run artifact."""
    from repro_torch.core.topology import Topology
    return [
        ("beluga4", Topology.full_mesh(4), (0, 1)),
        ("narval4", Topology.full_mesh(4, sublinks_per_pair=4,
                                       name="narval4"), (0, 1)),
        ("torus4x4", Topology.torus2d(4, 4), (0, 1)),
        ("hier2x4", Topology.hierarchical(2, 4, egress_per_island=2,
                                          name="hier2x4"), (1, 7)),
    ]


def _route_strs(plan) -> list[str]:
    """``src->via->dst`` strings, one per plan path, in share order."""
    return ["->".join(str(n) for n in (pa.route.hops[0].src,
                                       *(h.dst for h in pa.route.hops)))
            for pa in plan.paths]


def run_comm_dryrun(out_path: str,
                    fail_link: tuple[int, int] | None = None) -> list[dict]:
    """Plan-only sweep: ``session.describe`` over topology × size × paths,
    plus a schedule sweep over the shipped chunk-interleaving passes.

    Every ``comm_graph`` row is one transfer graph — node/edge counts,
    critical-path depth, canonical digest, and the analytic model's
    costs; every ``comm_schedule`` row is one (topology, size, scheduler)
    cell with the scheduled graph's modeled time and its delta vs the
    ``round_robin`` baseline (DESIGN.md §2.2). With ``fail_link`` every
    topology that carries that directional link additionally emits a
    ``comm_fault`` row: the steady-state plan before the fault and the
    surviving-routes re-plan after ``fail_link`` (routes, modeled
    bandwidth, DESIGN §4.6 ladder level), the restore leaving the
    topology untouched. Appended to ``out_path`` (replacing stale comm
    rows) next to any other rows so one JSON feeds
    ``repro_torch.launch.report``.
    """
    from repro_torch.comm import SCHEDULE_NAMES, CommConfig, CommSession

    MiB = 1 << 20
    rows = []
    for topo_name, topo, (src, dst) in _comm_topologies():
        sess = CommSession(CommConfig(multipath_threshold=MiB),
                           device="cpu", topology=topo)
        for nbytes in (1 * MiB, 8 * MiB, 64 * MiB):
            for max_paths in (1, 3):
                d = sess.describe(src, dst, nbytes, max_paths=max_paths)
                row = {"kind": "comm_graph", "status": "ok",
                       "topology": topo_name,
                       "nbytes": nbytes, "max_paths": max_paths,
                       "num_paths": d["num_paths"], **d["graph"],
                       **d["model"],
                       "islands": d["hierarchy"]["islands"],
                       "cross_island": d["hierarchy"]["cross_island"]}
                rows.append(row)
                print(f"COMM {topo_name} {nbytes >> 20}MiB "
                      f"paths={d['num_paths']} nodes={d['graph']['nodes']} "
                      f"edges={d['graph']['edges']} "
                      f"cp={d['graph']['critical_path_nodes']} "
                      f"bw={d['model']['effective_gbps']:.1f}GB/s",
                      flush=True)
        for nbytes in (8 * MiB, 64 * MiB):
            for sched in SCHEDULE_NAMES:
                d = sess.describe(src, dst, nbytes, max_paths=3,
                                  schedule=sched)
                s = d["schedule"]
                rows.append({
                    "kind": "comm_schedule", "status": "ok",
                    "topology": topo_name, "nbytes": nbytes,
                    "schedule": sched, "chosen": s["chosen"],
                    "nodes": d["graph"]["nodes"],
                    "digest": d["graph"]["digest"],
                    "scheduled_time_s": s["scheduled_time_s"],
                    "delta_vs_round_robin_s":
                        s["delta_vs_round_robin_s"],
                })
                print(f"SCHED {topo_name} {nbytes >> 20}MiB "
                      f"{sched}->{s['chosen']} "
                      f"t={s['scheduled_time_s'] * 1e6:.1f}us "
                      f"d={s['delta_vs_round_robin_s'] * 1e9:.0f}ns",
                      flush=True)
        if fail_link is not None:
            fsrc, fdst = fail_link
            # the reference tries ``link`` for a KeyError, which it never
            # raises (it returns None): an absent link then fails below
            if sess.topology.link(fsrc, fdst) is None:
                print(f"FAULT {topo_name}: no link {fsrc}->{fdst}, skipped",
                      flush=True)
                continue

            def _cell(level_hint=None):
                d = sess.describe(src, dst, 8 * MiB, max_paths=3)
                plan = sess.plan(src, dst, 8 * MiB, max_paths=3)
                level = (level_hint if level_hint is not None
                         else (1 if d["num_paths"] > 1 else 2))
                return {"num_paths": d["num_paths"],
                        "routes": _route_strs(plan),
                        "effective_gbps": d["model"]["effective_gbps"],
                        "scheduled_time_s":
                            d["schedule"]["scheduled_time_s"],
                        "level": level}

            before = _cell(level_hint=0)
            sess.topology.fail_link(fsrc, fdst)
            after = _cell()
            sess.topology.restore_link(fsrc, fdst)
            rows.append({"kind": "comm_fault", "status": "ok",
                         "topology": topo_name, "nbytes": 8 * MiB,
                         "src": src, "dst": dst,
                         "failed_link": [fsrc, fdst],
                         "before": before, "after": after})
            print(f"FAULT {topo_name} link {fsrc}->{fdst} down: "
                  f"paths {before['num_paths']}->{after['num_paths']} "
                  f"bw {before['effective_gbps']:.1f}->"
                  f"{after['effective_gbps']:.1f}GB/s "
                  f"ladder {before['level']}->{after['level']}",
                  flush=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    results = [r for r in results
               if r.get("kind") not in ("comm_graph", "comm_schedule",
                                        "comm_fault")]
    results.extend(rows)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\ncomm dry-run complete: {len(rows)} rows")
    return rows


def run_model_dryrun(out_path: str, *, arch: str | None = None,
                     shape: str | None = None, mesh: str = "both",
                     skip_existing: bool = False) -> list[dict]:
    """The model-cell sweep (module docstring); rows appended to
    ``out_path`` (a cell's earlier row replaced). Returns the JSON's
    rows."""
    from repro_torch.configs import REGISTRY, load_all
    from repro_torch.configs.shapes import SHAPES, skip_reason
    from repro_torch.launch.mesh import make_production_mesh

    load_all()
    archs = ([REGISTRY[arch.replace("-", "_")]] if arch
             else [REGISTRY[k] for k in sorted(REGISTRY)])
    shapes = ([SHAPES[shape]] if shape else list(SHAPES.values()))
    meshes = []
    if mesh in ("single", "both"):
        meshes.append(("single_pod_16x16", make_production_mesh()))
    if mesh in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16",
                       make_production_mesh(multi_pod=True)))

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    # comm rows share the file and have no arch (the reference's sweep
    # indexes them and raises)
    done = {(r.get("arch"), r.get("shape"), r.get("mesh")) for r in results
            if r.get("status") in ("ok", "skipped")}

    for a in archs:
        for sh in shapes:
            reason = skip_reason(a, sh)
            for mesh_name, m in meshes:
                key = (a.name, sh.name, mesh_name)
                if skip_existing and key in done:
                    print(f"SKIP(done) {key}", flush=True)
                    continue
                if reason:
                    row = {"arch": a.name, "shape": sh.name,
                           "mesh": mesh_name, "status": "skipped",
                           "reason": reason}
                    print(f"SKIP {key}: {reason}", flush=True)
                else:
                    t0 = time.time()
                    try:
                        row = run_cell(a, sh, m, mesh_name)
                        row["compile_s"] = round(time.time() - t0, 1)
                        row["note"] = NOTE
                        print(f"OK   {key} count={row['compile_s']}s "
                              f"mem/dev={row['memory_per_device_gb']:.2f}GiB "
                              f"bneck={row['bottleneck']} "
                              f"[c={row['compute_s']*1e3:.1f}ms "
                              f"m={row['memory_s']*1e3:.1f}ms "
                              f"n={row['collective_s']*1e3:.1f}ms] "
                              f"useful={row['useful_flops_ratio']:.2f}",
                              flush=True)
                    except Exception as e:  # noqa: BLE001
                        row = {"arch": a.name, "shape": sh.name,
                               "mesh": mesh_name, "status": "error",
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-2000:],
                               "compile_s": round(time.time() - t0, 1)}
                        print(f"FAIL {key}: {row['error']}", flush=True)
                results = [r for r in results if
                           (r.get("arch"), r.get("shape"),
                            r.get("mesh")) != key]
                results.append(row)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)

    cells = [r for r in results if "arch" in r]
    ok = sum(1 for r in cells if r.get("status") == "ok")
    sk = sum(1 for r in cells if r.get("status") == "skipped")
    er = sum(1 for r in cells if r.get("status") == "error")
    print(f"\ndry-run complete: ok={ok} skipped={sk} error={er}")
    return results


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default=None)
    parser.add_argument("--shape", default=None)
    parser.add_argument("--mesh", default="both",
                        choices=["single", "multi", "both"])
    parser.add_argument("--out", default="experiments/dryrun_results.json")
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--comm", action="store_true",
                        help="transfer-graph dry-run (plan-only, touches "
                             "no device)")
    parser.add_argument("--fail-link", metavar="SRC:DST", default=None,
                        help="with --comm: also emit before/after re-plan "
                             "rows with the directional link SRC:DST "
                             "failed (DESIGN §4.6 degraded mode)")
    args = parser.parse_args()

    if args.comm:
        fail = None
        if args.fail_link:
            try:
                a, b = args.fail_link.split(":")
                fail = (int(a), int(b))
            except ValueError:
                parser.error("--fail-link expects SRC:DST device ints, "
                             f"got {args.fail_link!r}")
        run_comm_dryrun(args.out, fail_link=fail)
        return
    if args.fail_link:
        parser.error("--fail-link only applies to the --comm dry-run")
    results = run_model_dryrun(args.out, arch=args.arch, shape=args.shape,
                               mesh=args.mesh,
                               skip_existing=args.skip_existing)
    if any(r.get("status") == "error" for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
