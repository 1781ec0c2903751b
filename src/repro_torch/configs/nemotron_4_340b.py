"""Nemotron-4 340B — dense GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron_4_340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    attention="full",
    mlp="relu2",
    rope_theta=10_000.0,
    fsdp=True,
    remat="full",
    optimizer_dtype="bfloat16",
    multi_pod=True,
    notes="squared-ReLU MLP (2 matrices); params+moments require "
          "FSDP(data)xTP(model) 2-D sharding to fit 16GB/chip; 340B "
          "params + bf16 moments exceed one pod's HBM, so launch "
          "resolves the 2-pod island-aware mesh/topology.",
))
