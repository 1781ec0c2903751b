"""The paper's application (§5.4) on the PyTorch port: a distributed
Jacobi solver with multi-path halo exchange.

The domain is column-partitioned over ``--ranks`` logical devices,
stacked as ``(ranks, rows, cols_per_rank)`` on one ``torch.device``;
each iteration exchanges halos with the ring neighbours and sweeps with
the ``jacobi`` kernel (its plain version on the CPU).

Run:  PYTHONPATH=src python examples_torch/jacobi_multipath.py [--iters 200]
      (on the card; ``--device cpu`` for the plain versions)

``--captured`` additionally runs the whole-iteration capture mode: sweep
+ halo exchange recorded as ONE heterogeneous transfer graph via
``session.capture``, so every iteration is exactly one engine dispatch
(the script prints the dispatch count to prove it).
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.halo import (jacobi_step,  # noqa: E402
                                   make_captured_jacobi_step)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--cols-per-rank", type=int, default=4096)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--captured", action="store_true",
                    help="also run the whole-iteration capture: sweep + "
                         "exchange as ONE graph, one dispatch per "
                         "iteration")
    ap.add_argument("--schedule", default=None,
                    help="chunk-interleaving schedule for the captured "
                         "graph (round_robin/depth_first/critical_path/"
                         "auto)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    n = args.ranks
    rng = np.random.RandomState(0)
    u0 = torch.from_numpy(rng.randn(n, args.rows, args.cols_per_rank)
                          .astype(np.float32)).to(device)

    def solve(multipath):
        u = u0
        for _ in range(args.iters):
            u = jacobi_step(u, multipath=multipath)
        return u

    for multipath in (False, True):
        solve(multipath)                    # warm up (builds the kernel)
        sync(device)
        t0 = time.perf_counter()
        u = solve(multipath)
        sync(device)
        dt = time.perf_counter() - t0
        resid = float(u.abs().max())
        tag = "multipath" if multipath else "single-path"
        print(f"{tag:12s}: {args.iters} iters in {dt:.3f}s "
              f"({dt / args.iters * 1e3:.2f} ms/iter), max|u|={resid:.4f}")

    if args.captured:
        from repro_torch.comm import CommSession
        from repro_torch.core.topology import Topology

        session = CommSession(device=device,
                              topology=Topology.full_mesh(n, with_host=True))
        captured = make_captured_jacobi_step(
            session, args.rows, args.cols_per_rank,
            schedule=args.schedule)
        entry = captured.resolve()      # lower + schedule + capture once
        g = entry.graph
        captured(u0)                    # warm launch
        sync(device)
        session.stats(reset=True)
        u = u0
        t0 = time.perf_counter()
        for _ in range(args.iters):
            u = captured(u, block=False)[0]
        sync(device)
        dt = time.perf_counter() - t0
        dispatches = session.stats()["dispatches"]
        resid = float(u.abs().max())
        print(f"{'captured':12s}: {args.iters} iters in {dt:.3f}s "
              f"({dt / args.iters * 1e3:.2f} ms/iter), max|u|={resid:.4f}")
        print(f"  one heterogeneous graph: {g.num_copy_nodes} copy + "
              f"{g.num_compute_nodes} compute nodes, schedule="
              f"{entry.schedule}; {dispatches} dispatches for "
              f"{args.iters} iterations (exactly one per step)")
    print("halo exchange over both direct and diagonal (staged) links")


if __name__ == "__main__":
    main()
