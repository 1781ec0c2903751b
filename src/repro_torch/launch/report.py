"""Generate EXPERIMENTS.md §Dry-run / §Roofline tables from sweep JSON.

Renders every row kind the dry-run emits: model compilation cells,
``--comm`` transfer-graph rows (copy-node/edge counts, critical-path
depth, modeled bandwidth — see ``session.describe``), the ``--comm``
schedule-sweep rows (modeled time per chunk-interleaving scheduler,
DESIGN.md §2.2), and the ``--comm --fail-link`` rows (before/after
re-plan routes and ladder level under a failed link, DESIGN.md §4.6).

The port of the reference package's ``launch/report.py``: the same
markdown from the same rows (``json`` and ``sys`` only).

Usage: PYTHONPATH=src python -m repro_torch.launch.report \
           experiments/dryrun_results.json > experiments/roofline.md
"""

from __future__ import annotations

import json
import sys


def fmt_table(rows: list[dict], mesh: str) -> str:
    out = [
        f"### Mesh `{mesh}`\n",
        "| arch | shape | kind | mem/dev GiB | compute s | memory s | "
        "collective s | bottleneck | MODEL_FLOPS | useful ratio | "
        "top collective |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                       f"| SKIP | — | — | {r['reason']} |")
            continue
        ops = r.get("collective_by_op", {})
        top = max(ops.items(), key=lambda kv: kv[1]["wire_bytes"],
                  default=(None, None))
        top_s = (f"{top[0]} {top[1]['wire_bytes']/1e9:.0f}GB"
                 if top[0] else "—")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {r['memory_per_device_gb']:.1f} "
            f"| {r['compute_s']:.2f} | {r['memory_s']:.2f} "
            f"| {r['collective_s']:.2f} | **{r['bottleneck']}** "
            f"| {r['model_flops']:.2e} | {r['useful_flops_ratio']:.2f} "
            f"| {top_s} |")
    return "\n".join(out) + "\n"


def fmt_comm_table(rows: list[dict]) -> str:
    """§Transfer graphs — one row per ``--comm`` dry-run lowering."""
    out = [
        "### Transfer graphs (`--comm` dry-run)\n",
        "| topology | MiB | paths | nodes | edges | critical path | "
        "launch µs (graph/per-node) | modeled GB/s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["topology"], r["nbytes"],
                                         r["max_paths"])):
        out.append(
            f"| {r['topology']} | {r['nbytes'] >> 20} | {r['num_paths']} "
            f"| {r['nodes']} | {r['edges']} | {r['critical_path_nodes']} "
            f"| {r['launch_overhead_ns'] / 1e3:.1f}/"
            f"{r['launch_overhead_nograph_ns'] / 1e3:.1f} "
            f"| {r['effective_gbps']:.1f} |")
    return "\n".join(out) + "\n"


def fmt_schedule_table(rows: list[dict]) -> str:
    """§Schedule sweep — modeled time per chunk-interleaving scheduler
    (DESIGN.md §2.2); delta is vs the ``round_robin`` baseline order."""
    out = [
        "### Schedule sweep (`--comm` dry-run)\n",
        "| topology | MiB | schedule | chosen | nodes | modeled µs | "
        "Δ vs round_robin ns |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["topology"], r["nbytes"],
                                         r["schedule"])):
        out.append(
            f"| {r['topology']} | {r['nbytes'] >> 20} | {r['schedule']} "
            f"| {r['chosen']} | {r['nodes']} "
            f"| {r['scheduled_time_s'] * 1e6:.1f} "
            f"| {r['delta_vs_round_robin_s'] * 1e9:+.0f} |")
    return "\n".join(out) + "\n"


def fmt_fault_table(rows: list[dict]) -> str:
    """§Link-fault re-plans — one before/after pair per ``--fail-link``
    dry-run cell (DESIGN.md §4.6): the steady-state routes, the
    surviving-routes re-plan once the link is down, and the ladder level
    each side runs at."""
    out = [
        "### Link-fault re-plans (`--comm --fail-link` dry-run)\n",
        "| topology | failed link | transfer | side | paths | routes | "
        "modeled GB/s | modeled µs | ladder |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: r["topology"]):
        link = "->".join(str(n) for n in r["failed_link"])
        xfer = f"{r['src']}->{r['dst']} {r['nbytes'] >> 20}MiB"
        for side in ("before", "after"):
            c = r[side]
            out.append(
                f"| {r['topology']} | {link} | {xfer} | {side} "
                f"| {c['num_paths']} | {', '.join(c['routes'])} "
                f"| {c['effective_gbps']:.1f} "
                f"| {c['scheduled_time_s'] * 1e6:.1f} | {c['level']} |")
    return "\n".join(out) + "\n"


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else \
        "experiments/dryrun_results.json"
    rows = json.load(open(path))
    comm = [r for r in rows if r.get("kind") == "comm_graph"]
    sched = [r for r in rows if r.get("kind") == "comm_schedule"]
    faults = [r for r in rows if r.get("kind") == "comm_fault"]
    rows = [r for r in rows
            if r.get("kind") not in ("comm_graph", "comm_schedule",
                                     "comm_fault")]
    ok = [r for r in rows if r["status"] == "ok"]
    sk = [r for r in rows if r["status"] == "skipped"]
    print(f"Cells: {len(ok)} compiled, {len(sk)} skipped, "
          f"{len(rows) - len(ok) - len(sk)} errors; "
          f"{len(comm)} transfer graphs; {len(sched)} schedule cells; "
          f"{len(faults)} fault cells.\n")
    for mesh in ("single_pod_16x16", "multi_pod_2x16x16"):
        sub = [r for r in rows if r["mesh"] == mesh]
        if sub:
            print(fmt_table(sub, mesh))
    if comm:
        print(fmt_comm_table(comm))
    if sched:
        print(fmt_schedule_table(sched))
    if faults:
        print(fmt_fault_table(faults))


if __name__ == "__main__":
    main()
