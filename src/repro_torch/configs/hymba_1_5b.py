"""Hymba 1.5B — hybrid: parallel attention + mamba heads per layer.

[arXiv:2411.13676; hf] SWA on the attention branch (global on none —
meta-token mechanism omitted, noted in DESIGN.md); ssm_state=16.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba_1_5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention="swa",
    window=1024,
    mlp="swiglu",
    ssm_state=16,
    rope_theta=10_000.0,
    remat="full",
))
