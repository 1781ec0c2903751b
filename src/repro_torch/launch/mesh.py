"""Production machine shape and its comm topology (the topology half).

The single-pod machine is a 16×16 = 256-chip pod (data × model); the
multi-pod machine adds a leading pod axis (2 pods = 512 chips) carrying
pure data parallelism across the DCN. :func:`production_mesh_shape`
gives that shape and its axis names, :func:`make_production_topology`
the matching :class:`~repro_torch.core.topology.Topology` — the flat
16×16 torus for one pod, or two torus islands joined by DCN links
(island-aware, DESIGN §3.1) — and :func:`production_launch_spec` resolves
both from an architecture's ``multi_pod`` hint, so the launcher, the
dry-run and the planner agree on which machine a config runs on.

The reference package's ``make_production_mesh`` and ``make_host_mesh``,
which build device meshes, are not here: they wait for the port's mesh
modules (ROADMAP queue 1, peer GPUs). Nothing in this module touches a
device.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.core.topology import Topology

#: Per-chip DCN egress links joining two pods (a slice of hosts own the
#: data-center NICs), and the per-link DCN bandwidth class.
DCN_EGRESS_PER_POD = 4
DCN_LINK_GBPS = 25.0


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The (shape, axis names) of the production machine — resolvable
    without 256/512 devices (tests, specs)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_topology(*, multi_pod: bool = False) -> Topology:
    """The comm :class:`Topology` of the production machine.

    Single pod: the flat 16×16 torus (one island). Multi-pod: two such
    torus islands joined by :data:`DCN_EGRESS_PER_POD` DCN links — the
    planner's island-aware routing then keeps intra-pod traffic on the
    torus and stages cross-pod transfers through exactly one DCN hop.
    """
    if not multi_pod:
        return Topology.torus2d(16, 16, name="pod16x16")
    return Topology.hierarchical(
        2, 256, intra="torus", torus_shape=(16, 16),
        inter_gbps=DCN_LINK_GBPS, inter_kind="dcn",
        egress_per_island=DCN_EGRESS_PER_POD, name="pods2x16x16")


def production_launch_spec(arch: ArchConfig) -> dict:
    """Resolve the launch-time machine for ``arch``: mesh shape/axes plus
    the island-aware topology, all keyed off ``arch.multi_pod`` (the
    configs' statement of whether one pod's memory suffices)."""
    shape, axes = production_mesh_shape(multi_pod=arch.multi_pod)
    return {
        "arch": arch.name,
        "multi_pod": arch.multi_pod,
        "mesh_shape": shape,
        "mesh_axes": axes,
        "topology": make_production_topology(multi_pod=arch.multi_pod),
    }
