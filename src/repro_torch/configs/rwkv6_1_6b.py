"""RWKV-6 (Finch) 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892; unverified] 32 heads x 64; O(1) decode state.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6_1_6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    mlp="relu2",              # rwkv channel-mix is a squared-relu 2-matrix FFN
    rwkv_head_dim=64,
    remat="full",
))
