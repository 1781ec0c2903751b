"""Mixtral 8x22B — MoE 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf] SWA window 4096 per the Mistral lineage.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral_8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    attention="swa",
    window=4096,
    mlp="swiglu",
    num_experts=8,
    top_k=2,
    rope_theta=1_000_000.0,
    fsdp=True,
    remat="full",
    optimizer_dtype="bfloat16",
    notes="experts sharded over the model axis (EP); SWA makes long_500k "
          "decode eligible.",
))
