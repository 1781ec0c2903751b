"""Architecture configuration: the models the port serves.

``ArchConfig`` is the single source of truth the model builders and the
serving engine read; its fields, derived properties, ``param_count`` and
``reduced()`` are the reference package's, unchanged, so a configuration
and its smoke-sized twin mean the same model on both sides. One module per
ported architecture lives next to this file and registers itself in
``REGISTRY``.

``reduced()`` produces the CPU smoke-test configuration of the same family
(small widths/layers, tiny vocab, float32).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

Family = Literal["dense", "moe", "vlm", "hybrid", "ssm", "audio"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int            # query heads; 0 for attention-free
    num_kv_heads: int
    d_ff: int                 # dense FFN width, or per-expert width for MoE
    vocab_size: int
    head_dim: int | None = None

    # -- attention pattern --------------------------------------------------
    attention: str = "full"   # full | swa | local_global | none
    window: int | None = None
    local_global_ratio: int = 0   # gemma3: 5 local layers per 1 global
    causal: bool = True           # False → encoder-only (no decode shapes)

    # -- mixer/FFN variants ---------------------------------------------------
    mlp: str = "swiglu"       # swiglu | geglu | gelu | relu2
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25

    # -- SSM / hybrid ----------------------------------------------------------
    ssm_state: int = 0        # mamba state size N (hymba)
    rwkv_head_dim: int = 64   # rwkv6 head size

    # -- modality frontend stub (audio/vlm: precomputed embeddings) -----------
    frontend: str | None = None   # "audio" → (B, T, frontend_dim) features
    frontend_dim: int = 512

    # -- numerics / distribution hints ------------------------------------------
    rope_theta: float = 500000.0
    dtype: str = "bfloat16"
    fsdp: bool = False            # shard params/optimizer over data axis too
    multi_pod: bool = False       # needs >1 pod: launch resolves the pod-axis
                                  # mesh + hierarchical (island-aware) topology
    remat: str = "none"           # none | full  (activation checkpointing)
    optimizer_dtype: str = "float32"   # adam moment dtype (bf16/int8 for huge)
    scan_layers: bool = True
    notes: str = ""

    # -- derived -----------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    @property
    def attention_free(self) -> bool:
        return self.attention == "none"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4 skip table)."""
        return self.family in ("ssm", "hybrid") or self.attention in (
            "swa", "local_global")

    @property
    def decoder(self) -> bool:
        return self.causal

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stacked blocks + head)."""
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim_
        n = self.vocab_size * d           # embed
        if self.decoder:
            n += self.vocab_size * d      # untied lm head
        per_layer = 0
        if not self.attention_free:
            per_layer += d * self.num_heads * hd * 2        # wq, wo
            per_layer += d * self.num_kv_heads * hd * 2     # wk, wv
        if self.family == "ssm":  # rwkv6 mixer
            per_layer += 5 * d * d + 2 * d * d              # r,k,v,w,g + out
        if self.family == "hybrid" and self.ssm_state:
            d_i = d
            per_layer += d * 2 * d_i + d_i * d              # in/out proj
            per_layer += d_i * (2 * self.ssm_state + d // 16)  # B,C,dt
        mats = 3 if self.mlp in ("swiglu", "geglu") else 2
        if self.num_experts:
            per_layer += d * self.num_experts               # router
            per_layer += self.num_experts * mats * d * ff
            per_layer += self.num_shared_experts * mats * d * ff
        else:
            per_layer += mats * d * ff
        per_layer += 2 * d                                   # norms
        return n + L * per_layer + d

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed experts count)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        mats = 3 if self.mlp in ("swiglu", "geglu") else 2
        expert_p = self.num_experts * mats * self.d_model * self.d_ff
        active_p = self.top_k * mats * self.d_model * self.d_ff
        return full - self.num_layers * (expert_p - active_p)

    def reduced(self) -> "ArchConfig":
        """Same-family smoke config: tiny but structurally identical."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=2 if self.num_kv_heads else 0,
            head_dim=16 if not self.attention_free else None,
            d_ff=128,
            vocab_size=256,
            window=8 if self.window else None,
            num_experts=4 if self.num_experts else 0,
            top_k=min(2, self.top_k) if self.top_k else 0,
            num_shared_experts=min(1, self.num_shared_experts),
            ssm_state=8 if self.ssm_state else 0,
            rwkv_head_dim=16,
            frontend_dim=32 if self.frontend else 512,
            dtype="float32",
            remat="none",
            fsdp=False,
            multi_pod=False,
        )


# ---------------------------------------------------------------------------
REGISTRY: dict[str, ArchConfig] = {}

#: The architectures the port registers: the reference's ten, in its
#: order.
ARCH_IDS = (
    "gemma3_27b", "nemotron_4_340b", "llama3_8b", "smollm_360m",
    "mixtral_8x22b", "kimi_k2_1t_a32b", "chameleon_34b", "hymba_1_5b",
    "rwkv6_1_6b", "hubert_xlarge",
)


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    """Look up an architecture by id (dashes and underscores equivalent)."""
    key = name.replace("-", "_")
    if not REGISTRY:
        load_all()
    for cand in (name, key):
        if cand in REGISTRY:
            return REGISTRY[cand]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")


def load_all() -> dict[str, ArchConfig]:
    for mod in ARCH_IDS:
        importlib.import_module(f"repro_torch.configs.{mod}")
    return REGISTRY
