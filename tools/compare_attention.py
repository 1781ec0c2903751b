"""Time the port's attention kernels of one or more checkouts, in turns.

Each ``--src`` is a checkout's ``src/`` directory (its kernels are built
from that checkout's sources into its own ``build/``). The checkouts run
in the order given and then in reverse (A, B, B, A for two), each in a
fresh process on the same card, so that two versions are compared within
one run. Each run times, with CUDA events:

* the backward (``flash_attention_bwd_cuda``) at path J's shape, (8,
  15/5, 512, 64) causal, bfloat16 and float32, as back-to-back calls and
  as one call captured in a CUDA graph and replayed (no host work
  between launches), and the bfloat16 one's kernels by name under
  ``torch.profiler`` (device ms a call);
* the forward with ``lse`` at that shape, and the forward alone at path
  E's (4, 32/8, 512, 128) and path F's (4, 32, 2048, 128), bfloat16
  causal, back to back and as a replayed graph.

Usage, on a machine with a card::

    python tools/compare_attention.py --src ../parent/src --src src

Prints one JSON line per run and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


def _one(src: str) -> dict:
    """The timings of the checkout whose ``src/`` is ``src``."""
    sys.path.insert(0, os.path.abspath(src))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import kernel as fk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    out = {"src": src}
    b, hq, hkv, s, d = 8, 15, 5, 512, 64
    for dt in (torch.bfloat16, torch.float32):
        q, k = (randn(b, h, s, d, dtype=dt) * 0.5 for h in (hq, hkv))
        v = randn(b, hkv, s, d, dtype=dt)
        do = randn(b, hq, s, d, dtype=dt)
        o, lse = fk.flash_attention_cuda(q, k, v, return_lse=True)

        def bwd():
            return fk.flash_attention_bwd_cuda(q, k, v, o, lse, do)

        name = str(dt)[6:]
        out[f"bwd_{name}_ms"] = _time_ms(torch, bwd)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            bwd()
        out[f"bwd_{name}_graph_ms"] = _time_ms(torch, graph.replay)
        if dt == torch.bfloat16:
            out["fwd_lse_bf16_ms"] = _time_ms(
                torch, lambda: fk.flash_attention_cuda(q, k, v,
                                                       return_lse=True))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    bwd()
                torch.cuda.synchronize()
            out["bwd_bf16_kernels_ms"] = {
                e.key.replace("(anonymous namespace)::", "")
                .removeprefix("void ").split("(")[0]:
                e.self_device_time_total / 1e3 / e.count
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
    for label, (b, hq, hkv, s, d) in (("E", (4, 32, 8, 512, 128)),
                                      ("F", (4, 32, 32, 2048, 128))):
        q = randn(b, hq, s, d, dtype=torch.bfloat16)
        k, v = (randn(b, hkv, s, d, dtype=torch.bfloat16) for _ in range(2))
        out[f"fwd_{label}_ms"] = _time_ms(
            torch, lambda: fk.flash_attention_cuda(q, k, v))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fk.flash_attention_cuda(q, k, v)
        out[f"fwd_{label}_graph_ms"] = _time_ms(torch, graph.replay)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="a checkout's src/ directory (repeatable)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(_one(args.one)), flush=True)
        return 0
    if not args.src:
        ap.error("give at least one --src")
    order = args.src + args.src[::-1]
    for src in order:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--one", src])
        if rc:
            return rc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
