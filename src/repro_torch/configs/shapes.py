"""Assigned input-shape set (identical across the 10 LM-family archs).

``decode_32k``/``long_500k`` are serve steps (one new token against a
KV/state cache of ``seq_len``); the others are train steps / prefills.
The skip rules are the reference package's, recorded in DESIGN.md §4.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def skip_reason(arch: ArchConfig, shape: ShapeConfig) -> str | None:
    """None if the (arch × shape) cell runs; otherwise why it is skipped."""
    if not arch.decoder and shape.kind == "decode":
        return "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return "pure full-attention arch: long_500k requires sub-quadratic"
    return None


def cells(archs) -> list[tuple[ArchConfig, ShapeConfig, str | None]]:
    """All 40 (arch × shape) cells with their skip status."""
    out = []
    for a in archs:
        for s in SHAPES.values():
            out.append((a, s, skip_reason(a, s)))
    return out
