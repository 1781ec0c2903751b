"""Partition specs and the divisibility rule the sharding rules share.

The reference's module pins activation layouts with sharding constraints
(``constrain``, ``batch_*``, ``attn_qkv``, ``moe_buf``,
``weight_gathered``): layout hints to a compiler that partitions one
program over a device mesh. The port's sharding is device-stacked (every
logical device a row of one ``(n, ...)`` tensor), where such hints have
nothing to act on, so only what the rules use is here: :data:`DP`, the
:class:`PartitionSpec` type, :func:`_safe` and :func:`heads_shardable`.
"""

from __future__ import annotations

from repro_torch.launch.mesh import LogicalMesh, ambient_mesh

DP = ("pod", "data")   # logical batch axes (filtered per mesh)


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), an axis name, or a
    tuple of axis names (the dim split over their product, in order).
    Prints as the reference's partition spec does."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        comma = "," if len(self) == 1 else ""
        return f"PartitionSpec({', '.join(map(repr, self))}{comma})"

    __str__ = __repr__


P = PartitionSpec


def _safe(shape, spec, mesh: LogicalMesh) -> PartitionSpec:
    """``spec`` with every axis that is not in ``mesh``, has one device,
    or does not divide what is left of its dim dropped; an entry left
    with one axis becomes that name, with none None."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = [a for a in axes if a in mesh.axis_names]
        keep = []
        size = shape[i]
        for a in axes:
            n = mesh.shape[a]
            if n > 1 and size % n == 0:
                keep.append(a)
                size //= n
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return PartitionSpec(*out)


def heads_shardable(num_heads: int) -> bool:
    """True when the q-head count divides the ambient mesh's model axis
    (or no mesh is ambient)."""
    mesh = ambient_mesh()
    if mesh is None:
        return True
    return num_heads % mesh.shape.get("model", 1) == 0
