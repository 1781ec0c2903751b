"""Kimi K2 — trillion-parameter MoE, 384 experts top-8, 32B active.

[arXiv:2501.kimi2 paper-table; unverified] d_ff=2048 is the per-expert
width; one shared expert per layer as in the DeepSeek-V3-style recipe.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi_k2_1t_a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    attention="full",
    mlp="swiglu",
    num_experts=384,
    top_k=8,
    num_shared_experts=1,
    rope_theta=50_000.0,
    fsdp=True,
    remat="full",
    optimizer_dtype="int8",
    multi_pod=True,
    notes="1T total / ~32B active; EP(model) x FSDP(data) 2-D expert "
          "sharding; int8 Adam moments required to fit 16GB/chip at 256 "
          "chips (see EXPERIMENTS.md §Perf memory iteration); 1T params "
          "+ moments exceed one pod's HBM, so launch resolves the "
          "2-pod island-aware mesh/topology.",
))
