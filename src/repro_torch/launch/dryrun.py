"""Transfer-graph dry-run: plan-only ``session.describe`` rows.

``--comm`` runs :func:`run_comm_dryrun`: ``session.describe(...)`` over
the standard topologies (copy-node/edge counts, critical-path depth,
modeled times), a schedule sweep over the shipped chunk-interleaving
passes and, with ``--fail-link SRC:DST``, before/after re-plan rows with
that link down. Sessions are built on the CPU and nothing is launched:
the dry-run touches no device. ``repro_torch.launch.report`` renders the
rows.

The reference package's model-cell dry-run (compiling every arch × shape
cell on the production meshes and reading the compiler's cost analysis)
waits for a cost analysis of the port's steps (ROADMAP queue 1: the
launch specs, the model cells and the roofline); without ``--comm``
:func:`main` says so.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --comm \\
        [--fail-link SRC:DST] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import os


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


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="experiments/dryrun_results.json")
    parser.add_argument("--comm", action="store_true",
                        help="transfer-graph dry-run (plan-only, touches "
                             "no device)")
    parser.add_argument("--fail-link", metavar="SRC:DST", default=None,
                        help="with --comm: also emit before/after re-plan "
                             "rows with the directional link SRC:DST "
                             "failed (DESIGN §4.6 degraded mode)")
    args = parser.parse_args()
    if not args.comm:
        parser.error("only the --comm dry-run is ported; the model-cell "
                     "dry-run waits for a cost analysis of the port's "
                     "steps (ROADMAP queue 1)")
    fail = None
    if args.fail_link:
        try:
            a, b = args.fail_link.split(":")
            fail = (int(a), int(b))
        except ValueError:
            parser.error("--fail-link expects SRC:DST device ints, "
                         f"got {args.fail_link!r}")
    run_comm_dryrun(args.out, fail_link=fail)


if __name__ == "__main__":
    main()
