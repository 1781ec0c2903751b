"""End-to-end training driver of the PyTorch port: a SmolLM-family model
on the synthetic pipeline, with checkpointing and straggler detection.

Defaults are a ~4M-parameter model with SmolLM-360M's structure, a few
minutes on a CPU; ``--hundred-m`` trains the ~100M-parameter variant.

Run:  PYTHONPATH=src python examples_torch/train_smollm.py --steps 300
      (on the card; ``--device cpu`` for the plain versions)

``--manual-collectives`` switches gradient synchronization to explicit
data parallelism through a ``repro_torch.comm.CommSession`` (the
multipath ring all-reduce over its logical devices).

``--captured-step`` goes one further: the whole training step — grad
compute, multipath ring all-reduce, optimizer update — is captured as ONE
heterogeneous transfer graph via ``session.capture``, so each step is
exactly one engine dispatch (printed at the end).
"""

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.comm import CommSession  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import (DataConfig, SyntheticDataset,  # noqa: E402
                              batch_to)
from repro_torch.optim import OptimConfig  # noqa: E402
from repro_torch.runtime import StragglerDetector  # noqa: E402
from repro_torch.training import (TrainStepConfig, init_state,  # noqa: E402
                                  make_captured_dp_train_step,
                                  make_dp_train_step, make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--hundred-m", action="store_true",
                    help="full ~100M params (slow on CPU); default is a "
                         "~4M-param config with identical structure")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "smollm_ckpt"))
    ap.add_argument("--manual-collectives", action="store_true",
                    help="data-parallel grads via the CommSession's "
                         "multipath collectives")
    ap.add_argument("--captured-step", action="store_true",
                    help="capture the whole train step (grads + ring "
                         "all-reduce + update) as ONE graph: one engine "
                         "dispatch per step")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    base = get_config("smollm_360m")
    if args.hundred_m:
        cfg = dataclasses.replace(
            base, name="smollm_100m", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32768, dtype="float32", remat="none", fsdp=False)
    else:
        cfg = dataclasses.replace(
            base.reduced(), name="smollm_mini", num_layers=4,
            d_model=128, d_ff=512, vocab_size=4096)
    n = cfg.param_count()
    print(f"training {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")

    opt = OptimConfig(learning_rate=3e-3,
                      warmup_steps=max(1, args.steps // 20),
                      total_steps=args.steps)
    comm = None
    state = init_state(cfg, opt, generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    ds = SyntheticDataset(cfg, DataConfig(seq_len=args.seq,
                                          global_batch=args.batch))
    if args.captured_step:
        comm = CommSession(device=device)
        batch0 = batch_to(ds.batch_at(0), device)
        step_fn = make_captured_dp_train_step(
            cfg, TrainStepConfig(), opt, comm, state, batch0)
        print(f"captured DP step over {comm.num_devices} devices: "
              f"grads + ring all-reduce + update as ONE graph "
              f"(one dispatch per step)")
    elif args.manual_collectives:
        comm = CommSession(device=device)
        step_fn = make_dp_train_step(cfg, TrainStepConfig(), opt, comm)
        print(f"manual DP over {comm.num_devices} devices "
              f"(policy={comm.policy.name})")
    else:
        step_fn = make_train_step(cfg, TrainStepConfig(), opt, device=device)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    straggler = StragglerDetector()
    t_start = time.time()
    for step in range(args.steps):
        batch = batch_to(ds.batch_at(step), device)
        t0 = time.time()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        if straggler.observe(step, time.time() - t0):
            print(f"  straggler at step {step}")
        if step % max(1, args.steps // 15) == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"lr {float(m['lr']):.2e}")
        if (step + 1) % 100 == 0:
            ckpt.save(step + 1, state)
    ckpt.save(args.steps, state)
    ckpt.wait()
    print(f"done in {time.time()-t_start:.1f}s; "
          f"checkpoints in {args.ckpt_dir}")
    if args.captured_step:
        g = comm.stats()["graph"]
        print(f"captured-step accounting: {comm.stats()['dispatches']} "
              f"dispatches for {args.steps} steps; compiled "
              f"{g['copy_nodes_compiled']} copy + "
              f"{g['compute_nodes_compiled']} compute nodes")


if __name__ == "__main__":
    main()
