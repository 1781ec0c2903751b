"""Quickstart of the PyTorch port: the unified comm session API
(multi-path planning, the offline tuner, plan caching, captured sends).

One ``CommSession`` owns the topology, the path policy, the planner, and
the compiled-plan cache; every subsystem (training, serving) drives
communication through it. Every logical device is a row of one operand
on the session's ``torch.device``.

Run:  PYTHONPATH=src python examples_torch/quickstart.py
      (on the card; ``--device cpu`` for the plain versions)

``--nelems`` sets the executed message's length (the reference's 2**20
by default).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.comm import CommConfig, CommSession  # noqa: E402
from repro_torch.core.pipelining import (  # noqa: E402
    build_schedule, effective_bandwidth_gbps, estimate_transfer_time_s)
from repro_torch.core.topology import Topology  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--nelems", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # 1) describe the node: 4 GPUs, NVLink full mesh + PCIe host (Beluga)
    #    and open a session on it (greedy bandwidth-proportional policy)
    sess = CommSession(CommConfig(max_paths=4), device=device,
                       topology=Topology.full_mesh(4))
    topo = sess.topology

    # 2) plan a 64 MiB transfer GPU0 -> GPU1
    plan = sess.plan(0, 1, 64 << 20, max_paths=3)
    print(f"plan: {plan.num_paths} paths, {plan.num_nodes} copy nodes "
          f"(policy={sess.policy.name})")
    for pa in plan.paths:
        print(f"  {pa.route.kind:14s} via={pa.route.via} "
              f"share={pa.nbytes >> 20}MiB chunks={pa.num_chunks}")
    print(f"schedule: {len(build_schedule(plan))} chunk tasks")

    # 3) modeled bandwidth: single vs multi-path (paper Fig. 6)
    single = sess.plan(0, 1, 64 << 20, max_paths=1)
    speedup = (estimate_transfer_time_s(single, topo)
               / estimate_transfer_time_s(plan, topo))
    print(f"modeled: single {effective_bandwidth_gbps(single, topo):.0f} "
          f"GB/s -> multipath {effective_bandwidth_gbps(plan, topo):.0f} "
          f"GB/s ({speedup:.2f}x)")

    # 4) the offline tuner (paper §4.4) searches paths × chunks × host
    best = sess.tune(0, 1, 64 << 20)
    print(f"tuned: {best.num_paths} paths, {best.num_nodes} nodes")

    # 4b) the dry run: the scheduled graph and its modeled cost, no device
    #     work
    info = sess.describe(0, 1, 64 << 20, max_paths=3)
    print(f"describe: {info['graph']['copy_nodes']} copy nodes, schedule "
          f"{info['schedule']['chosen']}, modeled "
          f"{info['schedule']['scheduled_time_s'] * 1e6:.1f} us")

    # 5) execute for real on 8 logical devices, twice (cache hit)
    run = CommSession(device=device,
                      topology=Topology.full_mesh(8, with_host=False))
    msg = torch.arange(args.nelems, dtype=torch.float32, device=device)
    out = run.send(msg, 0, 5)
    assert torch.equal(out, msg)
    run.send(msg, 0, 5)

    # 5b) concurrent messages: one fused transfer group = one captured
    # launch, planned contention-aware (exchange patterns stay
    # link-disjoint)
    fwd, rev = run.exchange([(msg, 0, 5), (msg * 2, 5, 0)])
    assert torch.equal(rev, msg * 2) and torch.equal(fwd, msg)
    print(f"fused 2-message exchange OK; "
          f"dispatches={run.stats()['dispatches']}")

    # 6) collectives ride the same session + plan cache
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=gen).to(device)
    gathered = run.all_gather(x)
    assert torch.equal(gathered, x)
    print(f"executed transfer + all-gather OK; "
          f"plan cache: {run.stats()['cache']}")
    _, compiled = next(iter(run.cache._store.items()))
    life = compiled.lifecycle
    print(f"lifecycle: trace {life.trace_ns/1e6:.1f}ms, "
          f"lower {life.lower_ns/1e6:.1f}ms, "
          f"instantiate {life.compile_ns/1e6:.1f}ms, "
          f"mean launch {life.mean_launch_ns/1e6:.2f}ms "
          f"({life.launches} launches)")


if __name__ == "__main__":
    main()
