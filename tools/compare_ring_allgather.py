"""Time two or more checkouts' ``ring_allgather`` kernels on one card, in turns.

Each ``--src`` is the ``src/`` directory of a checkout: this one's, or a
parent commit's unpacked beside it into a directory that ``.gitignore``
lists. The tool starts one worker process per ``--src``, in the order
given and then in reverse (A, B, B, A for two), on one card, so that two
versions are compared within one run. A worker imports ``repro_torch``
from its ``--src``, builds that checkout's kernels (into its own
``build/``) and, through the package's public functions only:

* at each of SHAPES, holds ``ring_allgather_cuda`` bitwise to
  ``ring_allgather_plain`` and times the call (CUDA events, back to back:
  host-bound for a small gather), the kernel's own device ms a call
  (``torch.profiler``, 20 calls), its bound, (n + n²)·S bytes at 3.35
  TB/s, and the library call ``xs.reshape(1, n*rows, f).expand(n, -1,
  -1).contiguous()``;
* times the stacked session's calls that run the kernel: path S's MoE
  combine (``session.collectives.psum`` of (4, 2048, 6144) bfloat16
  rows, whose gather has (1572864, 2) shards), the driver-level
  ``all_gather`` of 256 MiB and ``psum`` of (4097, 4095) float32, and
  reads the combine's device ms by kernel under ``torch.profiler``.

Usage, on a machine with a card::

    mkdir -p .chip_work/parent
    git archive HEAD~1 | tar -x -C .chip_work/parent
    python3 tools/compare_ring_allgather.py --src .chip_work/parent/src \\
        --src src

Prints one JSON line per worker run and, last, the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: H100 HBM3 (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: (n, rows, f, dtype): the all-gather of path B (256 MiB float32), in
#: bfloat16, path S's combine gather, path V's psum gather, and a (rows, 2)
#: shard of 6,291,452 bytes, not a multiple of 16.
SHAPES = ((4, 2048, 8192, "float32"), (4, 2048, 8192, "bfloat16"),
          (4, 1_572_864, 2, "bfloat16"), (4, 2_097_152, 2, "float32"),
          (4, 1_572_863, 2, "bfloat16"))


def worker(src: str) -> dict:
    sys.path.insert(0, os.path.abspath(src))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.comm import CommConfig, CommSession
    from repro_torch.kernels import _build
    from repro_torch.kernels.ring_allgather import kernel as rk

    def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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

    def device_ms(fn, iters: int = 20) -> dict:
        """Self device ms a call of each device-side event of ``fn``."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total:
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("(")[0][:60]
                out[name] = e.self_device_time_total / 1e3 / iters
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    dev = torch.device("cuda", 0)
    _build.build_all(("multipath_dma", "ring_allgather"))
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    row = {"src": src, "kernel": {}, "session": {}}
    for n, rows, f, dt in SHAPES:
        xs = randn(n, rows, f, dtype=getattr(torch, dt))
        if not torch.equal(rk.ring_allgather_cuda(xs),
                           rk.ring_allgather_plain(xs)):
            raise RuntimeError(f"{src}: ring_allgather ({n}, {rows}, {f}) "
                               f"{dt} differs from its plain version")
        size = rows * f * xs.element_size()
        row["kernel"][f"({n}, {rows}, {f}) {dt}"] = {
            "ms": time_ms(lambda: rk.ring_allgather_cuda(xs)),
            "device_ms": device_ms(lambda: rk.ring_allgather_cuda(xs)).get(
                "ring_allgather_kernel"),
            "bound_ms": (n + n * n) * size / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_ms(lambda: xs.reshape(1, -1, f)
                                  .expand(n, -1, -1).contiguous())}
        del xs
    sess = CommSession(CommConfig(health=False), device=dev)
    comb = randn(4, 2048, 6144, dtype=torch.bfloat16)
    big = randn(4 * 2048, 8192)
    odd = randn(4097, 4095)
    for name, fn in (("combine_psum (4, 2048, 6144) bf16",
                      lambda: sess.collectives.psum(comb)),
                     ("all_gather (8192, 8192) f32",
                      lambda: sess.all_gather(big)),
                     ("psum (4097, 4095) f32", lambda: sess.psum(odd))):
        row["session"][name] = time_ms(fn, 10)
    row["combine_device_ms"] = device_ms(
        lambda: sess.collectives.psum(comb), 5)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a checkout's src/ directory (repeat)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.src[0])), flush=True)
        return 0
    order = args.src + args.src[::-1]
    for src in order:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", "--src", src], cwd=ROOT,
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, flush=True)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"card: {smi[0] if smi else 'unknown'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
