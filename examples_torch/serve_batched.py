"""Batched serving on the PyTorch port: prefill + KV-cache decode with
mixed request lengths (greedy decoding, reduced Llama-3 config, seeded
random weights), plus KV-cache migration between logical devices through
the comm session (prefill→decode disaggregation).

On the card the engine's prefill and decode steps are captured CUDA
graphs, replayed after their first call.

Run:  PYTHONPATH=src python examples_torch/serve_batched.py
      (on the card; ``--device cpu`` for the plain versions)
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.comm import CommSession  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

#: (prompt length, new tokens) of each request, the reference's.
REQUESTS = ((6, 12), (10, 8), (4, 16), (8, 10))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config("llama3_8b").reduced()
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=device).manual_seed(args.seed), device=device)
    comm = CommSession(device=device,
                       topology=Topology.full_mesh(8, with_host=True))
    engine = ServeEngine(cfg, params, max_len=96, kv_chunks=4, comm=comm)

    gen = torch.Generator().manual_seed(args.seed + 1)
    requests = [Request(prompt=torch.randint(0, cfg.vocab_size, (plen,),
                                             generator=gen).tolist(),
                        max_new_tokens=new)
                for plen, new in REQUESTS]

    t0 = time.time()
    done = engine.generate(requests)
    dt = time.time() - t0
    total = sum(len(r.out) for r in done)
    for i, r in enumerate(done):
        print(f"req{i}: prompt_len={len(r.prompt)} -> {len(r.out)} new "
              f"tokens: {r.out[:10]}{'...' if len(r.out) > 10 else ''}")
    print(f"{total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s, "
          f"batch of {len(requests)})")

    # KV migration: a prefill node hands its cache to a decode node
    # through the session's captured multi-path plans (cache hit on
    # repeat).
    plen = max(len(r.prompt) for r in done)
    toks = torch.tensor([[0] * (plen - len(r.prompt)) + r.prompt
                         for r in done], dtype=torch.int64, device=device)
    _, cache = engine.prefill(toks)
    moved = engine.migrate_kv(cache, src=0, dst=5)
    ok = all(torch.equal(cache[k], moved[k]) for k in cache)
    engine.migrate_kv(cache, src=0, dst=5)   # second round: pure hits
    print(f"KV migration OK={ok}; comm cache: "
          f"{engine.comm.stats()['cache']}")


if __name__ == "__main__":
    main()
