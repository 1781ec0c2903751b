"""Gemma-3 27B — dense, 5:1 local:global attention, 128k-class context.

[hf:google/gemma-3-1b-pt scaled per released 27B card; unverified]
Local layers use 1024-token sliding windows; every 6th layer is global.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3_27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    attention="local_global",
    window=1024,
    local_global_ratio=5,
    mlp="geglu",
    rope_theta=1_000_000.0,
    fsdp=True,
    remat="full",
    optimizer_dtype="bfloat16",
    notes="5 local (SWA-1024) layers per 1 global layer; GeGLU MLP; "
          "long_500k decode keeps full KV on the 1/6 global layers "
          "(linear per-token cost) and windowed KV semantics on local.",
))
