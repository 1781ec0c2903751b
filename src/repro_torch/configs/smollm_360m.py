"""SmolLM 360M — llama-architecture small model. [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm_360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    attention="full",
    mlp="swiglu",
    rope_theta=10_000.0,
    remat="full",
))
