"""Llama-3 8B — dense GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3_8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    attention="full",
    mlp="swiglu",
    rope_theta=500_000.0,
    fsdp=True,
    remat="full",
))
