"""Time two or more sources of the RWKV-6 scan's backward kernel, in turns.

Each ``--cu`` is a version of ``rwkv6_scan_bwd.cu`` (its C entry point
``rwkv6_scan_bwd_launch`` is the same in every version); each is built
with ``nvcc`` and the flags of ``repro_torch.kernels._build`` into its own
library under ``build/compare_rwkv6_bwd/``, and called through this
checkout's wrapper (``rwkv6_scan_bwd_cuda``) with that library in place
of the built one. The versions run in the order given and then in reverse
(A, B, B, A for two), on one card in one process, so that two versions
are compared within one run. Each run, at path M's shape (8, 512, 32, 64,
64), chunks of 64, bfloat16 r/k/v and float32 w/u/dO, from the forward
kernel's chunk-start states:

* holds each of dr, dk, dv, dw, du to the plain version
  (``rwkv6_scan_bwd_plain``): the largest error over the largest |want|,
  within 2e-2 for the bfloat16 gradients and 1e-4 for the float32 ones,
  else the tool exits nonzero;
* times the backward with CUDA events as back-to-back calls and as one
  call captured in a CUDA graph and replayed;
* reads its kernels' device ms a call by name under ``torch.profiler``.

Usage, on a machine with a card, the parent commit's source beside this
checkout's::

    git show HEAD~1:src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan_bwd.cu \\
        > .chip_work/parent_bwd.cu
    python tools/compare_rwkv6_bwd.py --cu .chip_work/parent_bwd.cu \\
        --cu src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan_bwd.cu

Prints one JSON line per run and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: Path M's shape: (B, S, H, dk, dv) and the chunk.
SHAPE = (8, 512, 32, 64, 64)
CHUNK = 64
#: The bound on each gradient's largest error over its largest |want|.
REL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def _build_all(sources: list[str]) -> list[Path]:
    """One ``nvcc`` per source, all started together; the libraries'
    paths, named by a hash of each source."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "compare_rwkv6_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    started = []
    for src in sources:
        digest = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:16]
        lib = out_dir / f"librwkv6_scan_bwd-{digest}.so"
        proc = None
        if not lib.exists():
            proc = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started.append((src, lib, proc))
    for src, lib, proc in started:
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    return [lib for _, lib, _ in started]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cu", action="append", default=[],
                    help="a version of rwkv6_scan_bwd.cu (repeatable)")
    args = ap.parse_args()
    if not args.cu:
        ap.error("give at least one --cu")

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import kernel as sk

    libs = [ctypes.CDLL(str(p)) for p in _build_all(args.cu)]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, h, dk, dv = SHAPE

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    r, k = (randn(b, s, h, dk, scale=0.5).to(torch.bfloat16)
            for _ in range(2))
    v = randn(b, s, h, dv).to(torch.bfloat16)
    w = 0.3 + 0.699 * torch.rand(b, s, h, dk, generator=gen, device=dev)
    u = randn(h, dk, scale=0.3).expand(b, h, dk)
    do = randn(b, s, h, dv)
    _, _, states = sk.rwkv6_scan_fwd_cuda(r, k, v, w, u, chunk=CHUNK,
                                          out_dtype=torch.float32)
    want = sk.rwkv6_scan_bwd_plain(r, k, v, w, u, do, chunk=CHUNK,
                                   states=states)

    def bwd():
        return sk.rwkv6_scan_bwd_cuda(r, k, v, w, u, do, states=states,
                                      chunk=CHUNK)

    order = list(range(len(libs)))
    ok = True
    for i in order + order[::-1]:
        _build._LIBS["rwkv6_scan_bwd"] = libs[i]
        out = {"cu": args.cu[i], "shape": list(SHAPE), "chunk": CHUNK}
        rel = {}
        for name, got, ref in zip(("dr", "dk", "dv", "dw", "du"), bwd(),
                                  want):
            rel[name] = ((got.float() - ref.float()).abs().max()
                         / ref.float().abs().max()).item()
            ok &= rel[name] <= REL[str(got.dtype)[6:]]
        out["rel_err"] = rel
        out["ms"] = _time_ms(torch, bwd)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            bwd()
        out["graph_ms"] = _time_ms(torch, graph.replay)
        del graph
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                bwd()
            torch.cuda.synchronize()
        out["kernels_ms"] = {
            e.key.replace("(anonymous namespace)::", "")
            .removeprefix("void ").split("(")[0].split("<")[0]:
            e.self_device_time_total / 1e3 / e.count
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "rwkv6_bwd_" in e.key}
        print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if not ok:
        print("a version differs from the plain version beyond its bound",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
