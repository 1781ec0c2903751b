"""HuBERT X-Large — encoder-only audio transformer. [arXiv:2106.07447; unverified]

The conv waveform frontend is a STUB: input_specs() provides precomputed
frame embeddings (B, T, 512) projected into d_model. No decode shapes.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert_xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    attention="full",
    causal=False,
    mlp="gelu",
    frontend="audio",
    frontend_dim=512,
    remat="full",
))
