"""Serving driver: batched prefill + decode on a reduced config.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
        --requests 4 --new-tokens 16            # on cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \
        --device cpu                            # hybrid; mixtral_8x22b: MoE

Every architecture id of ``repro_torch.configs.ARCH_IDS`` is served at
its reduced size.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import Request, ServeEngine

    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3_8b")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch).reduced()
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    engine = ServeEngine(cfg, params, max_len=args.max_len,
                         kv_chunks=4, temperature=args.temperature)
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size,
                                         (args.prompt_len,),
                                         generator=rng).tolist(),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    t0 = time.time()
    done = engine.generate(reqs)
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    for i, r in enumerate(done):
        print(f"req{i}: prompt[:4]={r.prompt[:4]} -> out[:8]={r.out[:8]}")
    print(f"{total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s batched, {device})")


if __name__ == "__main__":
    main()
