"""Optimizer: AdamW with float32, bfloat16 or int8 moments."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptimConfig, apply_updates, global_norm, init_opt_state, lr_schedule,
    opt_state_shapes)
