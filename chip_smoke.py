"""Drive the port's main path on one CUDA card and check every kernel.

Run from the root of a checkout, on a machine with an NVIDIA H100::

    python3 chip_smoke.py

What it does, in order (any failed check exits nonzero):

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   three CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` per source, started together), printing the build seconds;
2. holds ``multipath_dma`` against its plain version, bit for bit:
   ``Topology.full_mesh(4)`` plans with 1/2/3 paths, 1/4/8 chunks,
   float32 and bfloat16, window 1 and 2, a 4-message exchange group, and a
   ``torus2d(4, 4)`` send with 3-hop chains through the engine; the
   kernel's completion counter must equal the graph's copy-node count;
3. holds ``jacobi`` against its plain version (float32 atol 1e-6, bfloat16
   atol 2e-2 on inputs in [-1, 1)) at W = 700 and W = 2**22, and
   ``ring_allgather`` against its plain version, bit for bit, at n = 4 and
   8, ``(rows, f)`` = (8, 128), (4, 64), (8, 7), (2048, 8192), float32
   and bfloat16 (completed items = table size);
4. main path A, with every launch counter set to 0 just before it and read
   after phase 5: a ``CommSession(schedule="auto")`` on the default
   4-device topology sends 256 MiB of float32 0→1 with 3 paths (bitwise),
   again (one fast-path hit, one dispatch, one kernel launch), a 64 MiB
   ``bidirectional`` and a 4-message ``exchange``;
5. the Jacobi application on that session: 4 ranks of (8, 2**22) float32,
   10 iterations of ``halo_exchange_group`` + the ``jacobi`` kernel, held
   against the plain stacked version (row shifts, plain sweep) within
   atol 1e-5;
6. main path B, counters set to 0 before it and read after it: the
   collectives of that session, each called twice (the second one cache
   hit, one replay) and held bit for bit against its plain version on the
   card: ``all_gather`` of a 256 MiB float32 ``(4*2048, 8192)`` array (all
   four replicas equal), ``reduce_scatter``, ``all_reduce`` and ``psum``
   of 64 MiB, ``all_to_all`` of ``(16, 2**20)``;
7. main path C: ``make_captured_jacobi_step`` at (4, 8, 2**22) float32,
   resolved first, then 10 iterations with the counters set to 0 just
   before: one dispatch per iteration, ``multipath_dma`` and ``jacobi``
   launched once per iteration per copy run, bit-equal to 10 eager
   ``jacobi_step(u, session=sess)``;
8. main path D: a captured step of ``captured_ring_allgather`` followed by
   a compute node, held bit for bit against the eager composition;
9. the kernels again at the main paths' shapes against their plain
   versions, then times from CUDA events: each kernel beside its bound,
   its plain version and a one-call PyTorch yardstick, a captured-graph
   replay against eager launches per dispatch at 64 KiB, sends of 64 KiB
   to 256 MiB (replay against one ``copy_`` of the message), the ring
   also at (8, 2048, 8192) float32 and (4, 2048, 8192) bfloat16, each
   collective's graph replay and ``session.all_gather`` per call, and the
   captured Jacobi iteration against the eager one;
10. one JSON line ``{"kernels": [...]}``, then as the last line
    ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
MiB = 1 << 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` back-to-back calls,
    from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean wall milliseconds per call of ``fn()`` followed by a device
    synchronize (host clock)."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.comm import (CommConfig, CommSession, PathPlanner,
                                  TransferRequest, lower)
    from repro_torch.comm import collectives as coll
    from repro_torch.core.halo import jacobi_step, make_captured_jacobi_step
    from repro_torch.core.topology import Topology
    from repro_torch.kernels import _build
    from repro_torch.kernels._graph import launch_counts, reset_launch_counts
    from repro_torch.kernels.jacobi import kernel as jk
    from repro_torch.kernels.multipath_dma import kernel as dk
    from repro_torch.kernels.multipath_dma import ops as dops
    from repro_torch.kernels.ring_allgather import kernel as rk
    from repro_torch.kernels.ring_allgather import ops as rops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(_build.KERNELS)}) into {_build.build_dir()}",
          flush=True)

    errs = {"multipath_dma": 0.0, "jacobi": 0.0, "ring_allgather": 0.0}
    gen = torch.Generator(device="cpu").manual_seed(0)
    dev_gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=dev_gen, device=dev).to(dtype)

    def table_vs_plain(graph, nelems, dtypes, ndev, fill="zero"):
        """Run one scheduled graph through the kernel and the plain
        version on the same inputs; both outputs must match bit for bit
        and the completion counter must equal the copy-node count."""
        table = dk.build_node_table(graph, nelems,
                                    [d.itemsize for d in dtypes], ndev,
                                    fill=fill)
        kern = dk.DmaProgram(table, dtypes, dev)
        for buf in kern.inputs():
            buf.copy_(torch.randn(buf.shape, generator=gen).to(buf.dtype))
        plain_y = torch.zeros_like(kern.y)
        plain_stage = torch.empty_like(kern.stage)
        kern.run()
        done = kern.completed_nodes()
        plain_done = dk.run_node_table_plain(table.items, kern.x, plain_y,
                                             plain_stage)
        torch.cuda.synchronize()
        check(torch.equal(kern.y, plain_y), "multipath_dma differs from its "
              "plain version")
        check(done == graph.num_copy_nodes == plain_done,
              f"completion counter {done} (plain {plain_done}) != "
              f"{graph.num_copy_nodes} copy nodes")
        return kern

    # -- 2. multipath_dma vs plain ----------------------------------------
    t0 = time.perf_counter()
    planner = PathPlanner(Topology.full_mesh(4), multipath_threshold=0)
    n = 1_000_003
    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        isz = dt.itemsize
        for paths in (1, 2, 3):
            for chunks in (1, 4, 8):
                plan = planner.plan(0, 1, n * isz, granularity=isz,
                                    max_paths=paths, num_chunks=chunks,
                                    include_host=False)
                x = randn(4, n, dtype=dt)
                got = dops.multipath_dma_transfer(x, plan)
                ref = x.clone()
                ref[plan.dst] = x[plan.src]
                check(torch.equal(got, ref), f"multipath_dma_transfer "
                      f"{dt} paths={paths} chunks={chunks}")
                for window in (1, 2):
                    table_vs_plain(lower(plan, window), [n], [dt], 4)
                    cases += 1
    group = planner.plan_group([TransferRequest(i, (i + 1) % 4, 4 * n, 4)
                                for i in range(4)])
    table_vs_plain(lower(group), [n] * 4, [torch.float32] * 4, 4)
    torus = CommSession(CommConfig(multipath_threshold=0), device=dev,
                        topology=Topology.torus2d(4, 4))
    msg = randn(n)
    got = torus.send(msg, 0, 1, max_paths=3, num_chunks=4)
    entry = next(iter(torus.engine._fastpath._store.values()))[1]
    hops = sorted(pa.route.num_hops for pa in entry.plans[0].paths)
    check(torch.equal(got, msg) and max(hops) == 3,
          f"torus2d(4,4) 3-hop send wrong (route hops {hops})")
    check(entry.compiled.program.completed_nodes()
          == entry.graph.num_copy_nodes, "torus completion counter")
    table_vs_plain(entry.graph, [n], [torch.float32], 16)
    print(f"multipath_dma vs plain: {cases} plan/window cases + exchange "
          f"group + torus2d(4,4) route hops {hops}: bitwise equal, "
          f"completion counter = copy nodes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- 3. jacobi vs plain -----------------------------------------------
    for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        for w in (700, 1 << 22):
            ext = (torch.rand(8, w + 2, generator=gen) * 2 - 1).to(dt).to(dev)
            got = jk.jacobi_sweep_cuda(ext)
            ref = jk.jacobi_sweep_plain(ext)
            err = (got.float() - ref.float()).abs().max().item()
            errs["jacobi"] = max(errs["jacobi"], err)
            check(err <= tol, f"jacobi {dt} W={w}: max abs err {err} > {tol}")
            print(f"jacobi vs plain {str(dt)[6:]} W={w}: max abs err {err} "
                  f"(atol {tol})", flush=True)

    t0 = time.perf_counter()
    cases = 0
    for n_dev in (4, 8):
        for rows_, f_ in ((8, 128), (4, 64), (8, 7), (2048, 8192)):
            for dt in (torch.float32, torch.bfloat16):
                xs = randn(n_dev, rows_, f_, dtype=dt)
                geo = rk.RingGeometry.for_shape(n_dev, rows_, f_, dt.itemsize)
                state = torch.empty(2 + geo.num_items, dtype=torch.int32,
                                    device=dev)
                got = rk.ring_allgather_cuda(xs, state=state)
                ref = rk.ring_allgather_plain(xs)
                check(torch.equal(got, ref), f"ring_allgather n={n_dev} "
                      f"({rows_}, {f_}) {dt} differs from plain")
                check(int(state[1].item()) == geo.num_items,
                      f"ring_allgather completed {int(state[1].item())} of "
                      f"{geo.num_items} items")
                cases += 1
                del xs, got, ref
    print(f"ring_allgather vs plain: {cases} cases bitwise equal, completed "
          f"items = table size ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    main_launches = {name: 0 for name in _build.KERNELS}
    per_path = {}

    def read_path(name: str) -> None:
        """Add the launch counters since the last reset to the main-path
        totals and print them."""
        counts = launch_counts()
        per_path[name] = {k: v for k, v in counts.items() if v}
        for k, v in counts.items():
            main_launches[k] += v
        print(f"main path {name} launches: {per_path[name]}", flush=True)

    # -- 4. main path A ----------------------------------------------------
    reset_launch_counts()
    sess = CommSession(schedule="auto")
    check(sess.device.type == "cuda", "session not on cuda")
    big = randn(1 << 26)                                  # 256 MiB f32
    t0 = time.perf_counter()
    out = sess.send(big, 0, 1, max_paths=3)
    first_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(out, big), "256 MiB send not bitwise exact")
    s1 = sess.stats()
    launches = dk.LAUNCHES
    out = sess.send(big, 0, 1, max_paths=3)
    s2 = sess.stats()
    check(torch.equal(out, big), "second 256 MiB send not bitwise exact")
    check(s2["fastpath"]["hits"] == s1["fastpath"]["hits"] + 1,
          "second send was not a fast-path hit")
    check(s2["dispatches"] == s1["dispatches"] + 1,
          "second send was not exactly one dispatch")
    check(dk.LAUNCHES == launches + 1,
          f"second send launched multipath_dma {dk.LAUNCHES - launches} "
          f"times, not once")
    main_entry = next(iter(sess.engine._fastpath._store.values()))[1]
    main_prog = main_entry.compiled.program
    check(main_prog.completed_nodes() == main_entry.graph.num_copy_nodes,
          "main send completion counter != copy nodes")
    print(f"send 256 MiB 0->1 max_paths=3: bitwise exact; first dispatch "
          f"{first_ms:.1f} ms (plan+table+capture), schedule "
          f"{main_entry.schedule}, {main_entry.graph.num_copy_nodes} copy "
          f"nodes, {main_prog.table.num_items} work items, paths "
          f"{[pa.route.via for pa in main_entry.plans[0].paths]}",
          flush=True)
    d0, l0 = sess.stats()["dispatches"], dk.LAUNCHES
    mid = big[: 16 * MiB]                                 # 64 MiB f32
    fwd, rev = sess.bidirectional(mid, 0, 2, max_paths=3)
    check(torch.equal(fwd, mid) and torch.equal(rev, mid),
          "64 MiB bidirectional not exact")
    quarter = [randn(4 * MiB) for _ in range(4)]          # 16 MiB each
    got = sess.exchange([(quarter[i], i, (i + 1) % 4) for i in range(4)],
                        max_paths=3)
    check(all(torch.equal(a, b) for a, b in zip(got, quarter)),
          "4-message exchange not exact")
    d1 = sess.stats()["dispatches"]
    check(d1 - d0 == 2 and dk.LAUNCHES - l0 >= 2,
          "bidirectional/exchange dispatch or launch count wrong")
    print("bidirectional 64 MiB and 4-message exchange: bitwise exact",
          flush=True)

    # -- 5. Jacobi application ---------------------------------------------
    ranks, rows, cols, iters = 4, 8, 1 << 22, 10
    u0 = randn(ranks, rows, cols)
    d0 = sess.stats()["dispatches"]
    t0 = time.perf_counter()
    u = u0
    for _ in range(iters):
        u = jacobi_step(u, session=sess, use_kernel=True)
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    halo_dispatches = sess.stats()["dispatches"] - d0
    read_path("A")
    check(per_path["A"].get("multipath_dma", 0) > 0
          and per_path["A"].get("jacobi", 0) > 0,
          "path A did not launch multipath_dma and jacobi")
    up = u0
    for _ in range(iters):
        up = jacobi_step(up, session=None, use_kernel=False)
    err = (u - up).abs().max().item()
    check(bool(torch.isfinite(u).all()) and tuple(u.shape) == (ranks, rows,
                                                               cols),
          "Jacobi output not finite or wrong shape")
    check(err <= 1e-5, f"Jacobi application max abs err {err} > 1e-5")
    check(halo_dispatches == iters, "halo exchange not one dispatch/iter")
    print(f"jacobi app {ranks}x({rows},{cols}) f32, {iters} iterations: "
          f"max abs err vs plain stacked {err} (atol 1e-5), "
          f"{app_s * 1e3 / iters:.2f} ms/iteration (host clock, first "
          f"iteration captures), one exchange dispatch per iteration",
          flush=True)

    # -- 6. main path B: collectives ----------------------------------------
    nd = sess.num_devices

    def plain_gather(xs):
        n_, s_ = xs.shape[:2]
        return rk.ring_allgather_plain(xs.reshape(n_, -1, xs.shape[-1])
                                       ).reshape((n_, n_ * s_)
                                                 + tuple(xs.shape[2:]))

    def plain_psum(xs):
        n_ = xs.shape[0]
        size = xs[0].numel()
        flat = torch.nn.functional.pad(xs.reshape(n_, -1),
                                       (0, (-size) % (2 * n_)))
        red = plain_gather(coll.bidir_ring_reduce_scatter(
            flat.reshape(n_, -1, 2)))
        return red.reshape(n_, -1)[:, :size].reshape(xs.shape)

    def coll_program(op):
        key = next(k for k in sess.cache.keys()
                   if getattr(k, "op", None) == op)
        return sess.cache._store[key]

    ag_x = randn(nd * 2048, 8192)                         # 256 MiB f32
    rs_x = randn(nd * 512, 8192)                          # 64 MiB f32
    a2a_x = randn(nd * nd, 1 << 20)                       # 64 MiB f32
    ps_x = randn(4097, 4095)                              # 64 MiB, odd
    rows_ag = ag_x.view(nd, 2048, 8192)
    expect = {
        "all_gather": ag_x,
        "reduce_scatter": coll.bidir_ring_reduce_scatter(
            rs_x.expand(nd, -1, -1)).reshape(rs_x.shape),
        "all_reduce": plain_gather(coll.bidir_ring_reduce_scatter(
            rs_x.expand(nd, -1, -1)))[0],
        "psum": plain_psum(ps_x.expand(nd, -1, -1))[0],
        "all_to_all": a2a_x.view(nd, nd, -1).transpose(0, 1).reshape(
            a2a_x.shape),
    }
    check(torch.equal(plain_gather(rows_ag)[1], ag_x),
          "plain all-gather is not the identity")
    inputs = {"all_gather": ag_x, "reduce_scatter": rs_x,
              "all_reduce": rs_x, "psum": ps_x, "all_to_all": a2a_x}
    reset_launch_counts()
    coll_ms = {}
    for op, x in inputs.items():
        t0 = time.perf_counter()
        got = getattr(sess, op)(x)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        check(torch.equal(got, expect[op]), f"session.{op} differs from "
              f"its plain version")
        c0 = sess.stats()["cache"]
        prog = coll_program(op)
        l0 = prog.lifecycle.launches
        got = getattr(sess, op)(x)
        c1 = sess.stats()["cache"]
        check(torch.equal(got, expect[op]), f"second session.{op} differs")
        check(c1["hits"] == c0["hits"] + 1 and c1["misses"] == c0["misses"],
              f"second session.{op} was not one cache hit")
        check(prog.lifecycle.launches == l0 + 1,
              f"second session.{op} was not exactly one replay")
        coll_ms[op] = first
        if op == "all_gather":
            (y,) = prog.outputs()
            check(all(torch.equal(y[d], ag_x) for d in range(nd)),
                  "all_gather replicas differ")
        print(f"session.{op} {tuple(x.shape)} {x.dtype}: bitwise equal to "
              f"plain, second call one cache hit + one replay; first call "
              f"{first:.1f} ms (build + capture)", flush=True)
    read_path("B")
    check(per_path["B"].get("ring_allgather", 0) > 0,
          "path B did not launch ring_allgather")
    del expect, got

    # -- 7. main path C: captured Jacobi ------------------------------------
    cap_step = make_captured_jacobi_step(sess, rows, cols)
    centry = cap_step.resolve()
    cprog = centry.compiled.program
    runs = [(len(r.nodes), r.table.num_items) for r in cprog.copy_runs]
    print(f"captured Jacobi: schedule {centry.schedule}, walk "
          f"{[type(w).__name__ for w in cprog.walk]}, copy runs (nodes, "
          f"items) {runs}, replay launches {cprog.replay_launches}",
          flush=True)
    ue = u0
    for _ in range(iters):
        ue = jacobi_step(ue, session=sess)
    d0 = sess.stats()["dispatches"]
    reset_launch_counts()
    uc = u0
    for _ in range(iters):
        (uc,) = cap_step(uc)
    torch.cuda.synchronize()
    cap_dispatches = sess.stats()["dispatches"] - d0
    read_path("C")
    check(cap_dispatches == iters, f"captured Jacobi took {cap_dispatches} "
          f"dispatches for {iters} iterations")
    check(per_path["C"].get("multipath_dma", 0) == iters * len(runs)
          and per_path["C"].get("jacobi", 0) == iters,
          f"captured Jacobi launches {per_path['C']} != one jacobi and "
          f"{len(runs)} multipath_dma per iteration")
    check(torch.equal(uc, ue), "captured Jacobi differs from eager "
          "jacobi_step")
    print(f"captured Jacobi {ranks}x({rows},{cols}) f32, {iters} iterations: "
          f"bitwise equal to eager jacobi_step, one dispatch per iteration",
          flush=True)

    # -- 8. main path D: captured ring all-gather + compute ------------------
    g_rows = 512

    def gather_scale(cap):
        g = rops.captured_ring_allgather(
            cap, cap.input((g_rows, 8192), torch.float32), nd)
        return cap.kernel(lambda t: t * 0.5 + 1.0, g, name="scale")

    gx = randn(nd, g_rows, 8192)                          # 16 MiB shards
    reset_launch_counts()
    gstep = sess.capture(gather_scale)
    (gout,) = gstep(gx)
    (gout,) = gstep(gx)
    torch.cuda.synchronize()
    read_path("D")
    check(per_path["D"].get("ring_allgather", 0) > 0,
          "path D did not launch ring_allgather")
    geager = rops.ring_allgather(gx).reshape(nd, nd * g_rows, 8192) * 0.5 \
        + 1.0
    check(torch.equal(gout, geager), "captured ring all-gather step differs "
          "from the eager composition")
    print("captured ring_allgather + compute node: bitwise equal to eager",
          flush=True)
    del gout, geager
    print(f"main-path launches (paths A-D): {main_launches}", flush=True)
    for name, count in main_launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    # -- 9a. kernels vs plain at the main path's shapes ---------------------
    plain_y = torch.zeros_like(main_prog.y)
    plain_stage = torch.empty_like(main_prog.stage)
    main_prog.inputs()[0][:, 0].copy_(big)
    main_prog.replay()
    dk.run_node_table_plain(main_prog.table.items, main_prog.x, plain_y,
                            plain_stage)
    torch.cuda.synchronize()
    check(torch.equal(main_prog.y, plain_y), "multipath_dma differs from "
          "plain at the main path's shape")
    ext4 = torch.cat([torch.zeros(ranks, rows, 1, device=dev), u0,
                      torch.zeros(ranks, rows, 1, device=dev)], dim=2)
    err4 = (jk.jacobi_sweep_cuda(ext4) - jk.jacobi_sweep_plain(ext4)
            ).abs().max().item()
    errs["jacobi"] = max(errs["jacobi"], err4)
    check(err4 <= 1e-6, f"jacobi at (4, 8, 2**22 + 2): err {err4}")
    ag_prog = coll_program("all_gather").program
    ring_got = rk.ring_allgather_cuda(rows_ag)
    check(torch.equal(ring_got, rk.ring_allgather_plain(rows_ag)),
          "ring_allgather differs from plain at the main path's shape")
    del ring_got
    print("kernels vs plain at the main path's shapes: multipath_dma "
          f"bitwise, jacobi max abs err {err4}, ring_allgather (4, 2048, "
          f"8192) bitwise", flush=True)

    # -- 9b. times ---------------------------------------------------------
    reads, writes = main_prog.table.bytes_moved()
    dma_bound = (reads + writes) / HBM_BYTES_PER_S * 1e3
    dma_ms = cuda_time_ms(main_prog.run, 20)
    replay_ms = cuda_time_ms(main_prog.replay, 20)
    dma_plain_ms = cuda_time_ms(
        lambda: dk.run_node_table_plain(main_prog.table.items, main_prog.x,
                                        plain_y, plain_stage), 5, warmup=1)
    x4 = main_prog.inputs()[0]
    y4 = main_prog.outputs()[0]
    # one PyTorch call computing the same function: the message in the
    # destination row, zeros in every other row
    dst_row = (torch.arange(4, device=dev) == 1).view(4, 1)
    zero = torch.zeros((), device=dev)
    where_out = torch.empty_like(y4[0])
    torch.where(dst_row, x4[0, 0], zero, out=where_out)
    check(torch.equal(where_out, y4[0]), "torch.where yardstick differs")
    where_ms = cuda_time_ms(
        lambda: torch.where(dst_row, x4[0, 0], zero, out=where_out), 20)
    copy_ms = cuda_time_ms(lambda: y4[0, 1].copy_(x4[0, 0]), 20)
    copy_bound = 2 * big.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"multipath_dma 256 MiB send: kernel {dma_ms:.4f} ms, graph "
          f"replay {replay_ms:.4f} ms, bound {dma_bound:.4f} ms "
          f"({reads} B read + {writes} B written incl. fills at 3.35 TB/s, "
          f"{dma_bound / dma_ms:.1%} of bound), plain {dma_plain_ms:.4f} ms, "
          f"torch.where into the (4, n) output {where_ms:.4f} ms, "
          f"out[dst].copy_(x[src]) of the message alone {copy_ms:.4f} ms "
          f"(its bound {copy_bound:.4f} ms)", flush=True)

    w = 1 << 22
    ext = randn(rows, w + 2)
    jac_ms = cuda_time_ms(lambda: jk.jacobi_sweep_cuda(ext), 50)
    jac_plain_ms = cuda_time_ms(lambda: jk.jacobi_sweep_plain(ext), 20)
    weight = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                           [0.0, 0.25, 0.0]], device=dev).view(1, 1, 3, 3)
    ext_nchw = ext.view(1, 1, rows, w + 2)
    conv = torch.nn.functional.conv2d(ext_nchw, weight, padding=(1, 0))
    conv_err = (conv.view(rows, w) - jk.jacobi_sweep_plain(ext)
                ).abs().max().item()
    conv_ms = cuda_time_ms(lambda: torch.nn.functional.conv2d(
        ext_nchw, weight, padding=(1, 0)), 20)
    jac_bound = (rows * (w + 2) + rows * w) * 4 / HBM_BYTES_PER_S * 1e3
    print(f"jacobi (8, 2**22 + 2) f32: kernel {jac_ms:.4f} ms, bound "
          f"{jac_bound:.4f} ms ({jac_bound / jac_ms:.1%} of bound), plain "
          f"{jac_plain_ms:.4f} ms, F.conv2d cross 3x3 (tf32 off) "
          f"{conv_ms:.4f} ms (max abs diff {conv_err})", flush=True)

    # graph replay vs eager launch per dispatch at 64 KiB (paper Figs 13/14)
    small = CommSession(CommConfig(multipath_threshold=0), device=dev)
    msg = randn(16 * 1024)                                # 64 KiB f32
    check(torch.equal(small.send(msg, 0, 1, max_paths=3, num_chunks=4), msg),
          "64 KiB send not exact")
    sentry = next(iter(small.engine._fastpath._store.values()))[1]
    sprog = sentry.compiled.program
    nodes = sentry.graph.num_copy_nodes
    rep_dev = cuda_time_ms(sprog.replay, 200, warmup=10)
    eager_dev = cuda_time_ms(sprog.run, 200, warmup=10)
    sy = torch.zeros_like(sprog.y)
    sst = torch.empty_like(sprog.stage)
    pernode_dev = cuda_time_ms(lambda: dk.run_node_table_plain(
        sprog.table.items, sprog.x, sy, sst), 50, warmup=5)
    rep_host = host_time_ms(sprog.replay, 200, warmup=10)
    eager_host = host_time_ms(sprog.run, 200, warmup=10)
    send_host = host_time_ms(
        lambda: small.send(msg, 0, 1, max_paths=3, num_chunks=4), 200,
        warmup=10)
    print(f"64 KiB send, 3 paths x 4 chunks = {nodes} copy nodes: graph "
          f"replay {rep_dev * 1e3:.2f} us/dispatch back to back "
          f"({rep_host * 1e3:.2f} us with a sync each), eager kernel launch "
          f"{eager_dev * 1e3:.2f} us ({eager_host * 1e3:.2f} us synced), "
          f"eager one copy_ per work item {pernode_dev * 1e3:.2f} us; whole "
          f"session.send {send_host * 1e3:.2f} us synced", flush=True)
    # send size sweep on the main session: graph replay vs one copy_
    for nbytes in (64 * 1024, MiB, 16 * MiB, 256 * MiB):
        m = big[: nbytes // 4]
        check(torch.equal(sess.send(m, 0, 1, max_paths=3), m),
              f"{nbytes} B send not exact")
        e = next(e for _, e in sess.engine._fastpath._store.values()
                 if e.key.entries == ((0, 1, m.numel(), "float32"),))
        prog = e.compiled.program
        rd, wr = prog.table.bytes_moved()
        rep = cuda_time_ms(prog.replay, 50, warmup=5)
        xin, yout = prog.inputs()[0], prog.outputs()[0]
        cp = cuda_time_ms(lambda: yout[0, 1].copy_(xin[0, 0]), 50, warmup=5)
        print(f"sweep {nbytes} B: {len(e.plans[0].paths)} paths, "
              f"{e.graph.num_copy_nodes} copy nodes, replay {rep * 1e3:.2f} "
              f"us (bound {(rd + wr) / HBM_BYTES_PER_S * 1e6:.2f} us), "
              f"copy_ of the message {cp * 1e3:.2f} us (bound "
              f"{2 * nbytes / HBM_BYTES_PER_S * 1e6:.2f} us)", flush=True)

    # ring_allgather at the all-gather's shape: (4, 2048, 8192) f32 shards
    shard = 2048 * 8192 * 4
    ring_floor = (nd + nd * nd) * shard / HBM_BYTES_PER_S * 1e3
    ring_bytes = sum(rk.RingGeometry.for_shape(nd, 2048, 8192, 4)
                     .bytes_moved()) / HBM_BYTES_PER_S * 1e3
    ring_ms = cuda_time_ms(lambda: rk.ring_allgather_cuda(rows_ag), 20)
    ring_plain_ms = cuda_time_ms(lambda: rk.ring_allgather_plain(rows_ag), 5,
                                 warmup=1)
    yard = rows_ag.reshape(1, nd * 2048, 8192).expand(nd, -1, -1).contiguous()
    check(torch.equal(yard, plain_gather(rows_ag)), "yardstick differs")
    del yard
    yard_ms = cuda_time_ms(lambda: rows_ag.reshape(1, nd * 2048, 8192)
                           .expand(nd, -1, -1).contiguous(), 20)
    ag_replay_ms = cuda_time_ms(ag_prog.replay, 20)
    ag_call_ms = host_time_ms(lambda: sess.all_gather(ag_x), 10)
    print(f"ring_allgather (4, 2048, 8192) f32: kernel {ring_ms:.4f} ms, "
          f"floor {ring_floor:.4f} ms ((n + n^2) S at 3.35 TB/s, "
          f"{ring_floor / ring_ms:.1%} of it), ring bytes {ring_bytes:.4f} "
          f"ms (2 n^2 S), plain {ring_plain_ms:.4f} ms, "
          f"reshape.expand.contiguous {yard_ms:.4f} ms; session.all_gather "
          f"256 MiB: graph replay {ag_replay_ms:.4f} ms, whole call "
          f"{ag_call_ms:.4f} ms synced (staging + replay + replica clone)",
          flush=True)

    # the ring at its other sizes, and each collective's graph replay
    for n_dev, dt in ((8, torch.float32), (4, torch.bfloat16)):
        xs = randn(n_dev, 2048, 8192, dtype=dt)
        s_bytes = 2048 * 8192 * dt.itemsize
        k_ms = cuda_time_ms(lambda: rk.ring_allgather_cuda(xs), 10)
        y_ms = cuda_time_ms(lambda: xs.reshape(1, -1, 8192)
                            .expand(n_dev, -1, -1).contiguous(), 10)
        print(f"ring_allgather ({n_dev}, 2048, 8192) {str(dt)[6:]}: kernel "
              f"{k_ms:.4f} ms, floor "
              f"{(n_dev + n_dev ** 2) * s_bytes / HBM_BYTES_PER_S * 1e3:.4f}"
              f" ms, ring bytes "
              f"{2 * n_dev ** 2 * s_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
              f"reshape.expand.contiguous {y_ms:.4f} ms", flush=True)
        del xs
    for op, x in inputs.items():
        rep = cuda_time_ms(coll_program(op).program.replay, 10)
        print(f"session.{op} {tuple(x.shape)}: graph replay {rep:.4f} ms",
              flush=True)

    # the paper's graph-vs-eager comparison at iteration scope
    cap_replay_ms = cuda_time_ms(cprog.replay, 10)
    cap_call_ms = host_time_ms(lambda: cap_step(uc), 10)
    eager_ms = cuda_time_ms(lambda: jacobi_step(uc, session=sess), 10)
    eager_host_ms = host_time_ms(lambda: jacobi_step(uc, session=sess), 10)
    print(f"Jacobi iteration {ranks}x({rows},{cols}) f32: captured graph "
          f"replay {cap_replay_ms:.4f} ms (CUDA events), whole captured "
          f"call {cap_call_ms:.4f} ms synced (input staging + replay + "
          f"output clone); eager jacobi_step {eager_ms:.4f} ms (CUDA "
          f"events), {eager_host_ms:.4f} ms synced", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)

    # -- 10. report --------------------------------------------------------
    kernels = [
        {"name": "multipath_dma", "route": "cuda",
         "source": "src/repro_torch/kernels/multipath_dma/csrc/"
                   "multipath_dma.cu",
         "replaces": "src/repro/kernels/multipath_dma/kernel.py:201",
         "launches": main_launches["multipath_dma"],
         "max_abs_err": errs["multipath_dma"], "ms": dma_ms,
         "plain_ms": dma_plain_ms, "bound_ms": dma_bound,
         "bound_by": "bytes", "library_ms": where_ms,
         "library_call": "torch.where(row == dst, x[src], 0) into the "
                         "(4, n) output (a single path: no staging)"},
        {"name": "jacobi", "route": "cuda",
         "source": "src/repro_torch/kernels/jacobi/csrc/jacobi.cu",
         "replaces": "src/repro/kernels/jacobi/kernel.py:47",
         "launches": main_launches["jacobi"],
         "max_abs_err": errs["jacobi"], "ms": jac_ms,
         "plain_ms": jac_plain_ms, "bound_ms": jac_bound,
         "bound_by": "bytes", "library_ms": conv_ms,
         "library_call": "F.conv2d with the cross-shaped 3x3 weights, "
                         "cudnn tf32 off"},
        {"name": "ring_allgather", "route": "cuda",
         "source": "src/repro_torch/kernels/ring_allgather/csrc/"
                   "ring_allgather.cu",
         "replaces": "src/repro/kernels/ring_allgather/kernel.py:87",
         "launches": main_launches["ring_allgather"],
         "max_abs_err": errs["ring_allgather"], "ms": ring_ms,
         "plain_ms": ring_plain_ms, "bound_ms": ring_floor,
         "bound_by": "bytes", "library_ms": yard_ms,
         "ring_bytes_ms": ring_bytes,
         "library_call": "xs.reshape(1, n*rows, f).expand(n, -1, -1)"
                         ".contiguous()"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
