"""Optimizer: AdamW with float32, bfloat16 or int8 moments, and int8
gradient compression."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptimConfig, apply_updates, global_norm, init_opt_state, lr_schedule,
    opt_state_shapes)
from repro_torch.optim.compression import (  # noqa: F401
    compressed_psum, compressed_psum_tree, compressed_psum_with_feedback)
