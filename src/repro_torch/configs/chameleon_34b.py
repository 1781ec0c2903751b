"""Chameleon 34B — early-fusion VLM; VQ image tokens share the text vocab.

[arXiv:2405.09818; unverified] The modality frontend is a STUB per the
pool rules: image patches arrive as precomputed VQ token ids inside the
unified 65536 vocab, so the backbone is a standard decoder.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon_34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    attention="full",
    mlp="swiglu",
    rope_theta=10_000.0,
    fsdp=True,
    remat="full",
    optimizer_dtype="bfloat16",
    frontend="vq_tokens",
))
