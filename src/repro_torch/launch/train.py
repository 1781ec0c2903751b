"""Training driver: data → train loop → checkpoints → straggler detection.

The counterpart of the reference's ``repro/launch/train.py``: the same
options and the same printed lines, on the card by default.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
        --reduced --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_1_6b \
        --reduced --device cpu      # or hymba_1_5b, mixtral_8x22b
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert_xlarge \
        --reduced --device cpu      # the audio encoder: feature batches

Every registered architecture trains (``--arch``), the audio encoder
``hubert_xlarge`` too: its batches are float32 frame features with a unit
label per frame.
"""

from __future__ import annotations

import argparse
import time

import torch


def build(arch_name: str, *, reduced: bool, steps: int, batch: int,
          seq: int, lr: float, microbatches: int, device, seed: int = 0):
    """``(cfg, step_fn, state, dataset)`` for one device."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_train_step)

    cfg = get_config(arch_name)
    if reduced:
        cfg = cfg.reduced()
    opt = OptimConfig(learning_rate=lr, warmup_steps=max(1, steps // 20),
                      total_steps=steps, moment_dtype=cfg.optimizer_dtype
                      if not reduced else "float32")
    ts = TrainStepConfig(microbatches=microbatches)
    step_fn = make_train_step(cfg, ts, opt, device=device)
    state = init_state(cfg, opt, generator=torch.Generator(
        device=device).manual_seed(seed), device=device)
    ds = SyntheticDataset(cfg, DataConfig(seq_len=seq, global_batch=batch))
    return cfg, step_fn, state, ds


def main(argv=None) -> None:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import batch_to
    from repro_torch.runtime import StragglerDetector

    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm_360m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    device = torch.device(args.device)
    cfg, step_fn, state, ds = build(
        args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, microbatches=args.microbatches,
        device=device)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None:
        restored = ckpt.restore_latest(state, device=device)
        if restored is not None:
            state, start, _ = restored[0], restored[1], restored[2]
            print(f"restored checkpoint at step {start}")

    straggler = StragglerDetector()
    t_begin = time.time()
    for step in range(start, args.steps):
        batch = batch_to(ds.batch_at(step), device)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if straggler.observe(step, dt):
            print(f"step {step}: straggler ({dt:.2f}s vs median "
                  f"{straggler.median_s:.2f}s)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt is not None:
        ckpt.save(args.steps, state)
        ckpt.wait()
    print(f"done: {args.steps - start} steps in {time.time()-t_begin:.1f}s")


if __name__ == "__main__":
    main()
