"""Roofline terms of a dry-run cell at the H100's data-sheet peaks.

Three terms per (arch × shape × mesh), all in seconds, per device:

* compute    = FLOPs / peak bf16              (989 TFLOP/s)
* memory     = HBM bytes / HBM bandwidth      (3.35 TB/s)
* collective = wire bytes / (links × 25 GB/s) (one NVLink 4 link, one
  direction)

FLOPs, bytes and the collective records come from the port's cost count
of a step (:mod:`repro_torch.launch.cost`). The collective term is
**modeled**: one card has no link to measure, and the program's
collectives are rows of one tensor there. Each record is one collective
call ``(op, result_bytes, group_size)``, priced with the ring model's
wire multiplier per op kind:

=================  ==========================================
op                 wire bytes per device (result size R)
=================  ==========================================
all-reduce         2·R·(n−1)/n
all-gather         R·(n−1)/n
reduce-scatter     R·(n−1)          (result is the scattered shard)
all-to-all         R·(n−1)/n
collective-permute R
=================  ==========================================

``links`` defaults to 1 (the single-path baseline); a multi-path
collective raises the usable link count.

The port of the reference package's ``launch/roofline.py``, whose input
is the compiler's cost analysis and the collectives parsed from its
program text; here the records are those the step's collective calls
make.
"""

from __future__ import annotations

import dataclasses

#: NVIDIA H100 SXM5 data sheet, 700 W: dense bfloat16 tensor-core peak.
PEAK_BF16_TFLOPS = 989.0
#: NVIDIA H100 SXM5 data sheet: HBM3 bandwidth.
HBM_GBPS = 3350.0
#: NVLink 4 per link and direction: the data sheet's 900 GB/s over 18
#: links, both directions counted.
NVLINK_LINK_GBPS = 25.0

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _wire_multiplier(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    total_wire_bytes: float = 0.0
    by_op: dict = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, op: str, wire: float):
        self.total_wire_bytes += wire
        d = self.by_op.setdefault(op, {"count": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += wire
        self.count += 1


def collective_bytes(records, default_group: int) -> CollectiveStats:
    """Per-device wire bytes of collective records ``(op, result_bytes,
    group_size)`` (a group size of None or 0 takes ``default_group``)."""
    stats = CollectiveStats()
    for op, rb, n in records:
        if op not in COLLECTIVES:
            raise ValueError(f"unknown collective {op!r}")
        stats.add(op, rb * _wire_multiplier(op, n or default_group))
    return stats


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   links: int = 1) -> tuple[dict, str]:
    """``({"compute", "memory", "collective"}: seconds, bottleneck)``."""
    terms = {"compute": flops / (PEAK_BF16_TFLOPS * 1e12),
             "memory": hbm_bytes / (HBM_GBPS * 1e9),
             "collective": wire_bytes / (links * NVLINK_LINK_GBPS * 1e9)}
    return terms, max(terms, key=terms.get)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float               # per-device flops
    hbm_bytes: float           # per-device bytes accessed
    wire_bytes: float          # per-device collective bytes (modeled)
    collective_by_op: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float         # 6·N·D (or 6·N_active·D) global
    useful_flops_ratio: float  # model_flops / (flops × chips)
    memory_per_device_gb: float
    peak_memory_gb: float | None = None
    links: int = 1
    note: str = ""

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(arch_name: str, shape_name: str, mesh_name: str, chips: int,
            cost: dict, records, model_flops: float,
            memory_bytes: float, *, default_group: int,
            peak_memory_bytes: float | None = None,
            links: int = 1, note: str = "") -> RooflineReport:
    """The roofline of one cell: ``cost`` holds ``flops`` and ``bytes
    accessed`` per device, ``records`` the collective records."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(records, default_group)
    terms, bottleneck = roofline_terms(flops, hbm, coll.total_wire_bytes,
                                       links)
    total_flops = flops * chips
    ratio = model_flops / total_flops if total_flops else 0.0
    return RooflineReport(
        arch=arch_name, shape=shape_name, mesh=mesh_name, chips=chips,
        flops=flops, hbm_bytes=hbm, wire_bytes=coll.total_wire_bytes,
        collective_by_op=coll.by_op, compute_s=terms["compute"],
        memory_s=terms["memory"], collective_s=terms["collective"],
        bottleneck=bottleneck, model_flops=model_flops,
        useful_flops_ratio=ratio,
        memory_per_device_gb=memory_bytes / 2**30,
        peak_memory_gb=(peak_memory_bytes / 2**30
                        if peak_memory_bytes else None),
        links=links, note=note)


def train_model_flops(n_active_params: float, tokens: float) -> float:
    return 6.0 * n_active_params * tokens


def decode_model_flops(n_active_params: float, batch: int) -> float:
    """One decode step processes ``batch`` tokens."""
    return 2.0 * n_active_params * batch  # fwd only


def prefill_model_flops(n_active_params: float, tokens: float) -> float:
    return 2.0 * n_active_params * tokens
