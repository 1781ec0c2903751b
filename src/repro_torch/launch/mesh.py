"""Production machine shape, its comm topology, and the logical mesh.

The single-pod machine is a 16×16 = 256-chip pod (data × model); the
multi-pod machine adds a leading pod axis (2 pods = 512 chips) carrying
pure data parallelism across the DCN. :func:`production_mesh_shape`
gives that shape and its axis names, :func:`make_production_topology`
the matching :class:`~repro_torch.core.topology.Topology` — the flat
16×16 torus for one pod, or two torus islands joined by DCN links
(island-aware, DESIGN §3.1) — and :func:`production_launch_spec` resolves
both from an architecture's ``multi_pod`` hint, so the launcher, the
dry-run and the planner agree on which machine a config runs on.

The mesh half. Sharding in the port is a device-stacked emulation: every
logical device is a row of one ``(n, ...)`` tensor on one
``torch.device``. A :class:`LogicalMesh` names the axes of those rows and
holds the :class:`~repro_torch.comm.session.CommSession` whose rows are
the model axis, so a model-axis reduction is one session collective per
index of the other axes (the session's collectives run over all of its
rows). A *peer mesh* has a peer session instead
(``CommSession(devices=[...])``, :func:`is_peer`): its model axis's
logical devices are tensors on devices of their own, one or several a
card. :func:`make_host_mesh` builds either over a session (the reference
builds its mesh over whatever devices exist), :func:`make_production_mesh`
the production shape with no session (its specs only), and
:func:`set_mesh` makes a mesh ambient for the code that reads it
(:func:`ambient_mesh`), as the reference's ``set_mesh`` context does.
Nothing in this module touches a device but the session it is given or
builds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import TYPE_CHECKING

from repro_torch.configs.base import ArchConfig
from repro_torch.core.topology import Topology

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.comm.session import CommSession

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


@dataclasses.dataclass(frozen=True, eq=False)
class LogicalMesh:
    """Named axes over logical devices, each a row of a device-stacked
    tensor: ``axis_names`` and their sizes (``shape``, an ordered dict as
    the reference's mesh has), and the :class:`CommSession` that a
    model-axis collective runs on (None for a mesh that only resolves
    specs, such as the production shape). The session's rows are the
    model axis: its device count equals ``shape["model"]``."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    session: "CommSession | None" = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(
                n < 1 for n in self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.sizes} disagree")
        if self.session is not None:
            model = self.shape.get("model", 1)
            if self.session.num_devices != model:
                raise ValueError(
                    f"the mesh's session has {self.session.num_devices} "
                    f"devices, its model axis {model}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"LogicalMesh({axes})"


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The production machine's mesh (:func:`production_mesh_shape`), with
    no session: it resolves sharding specs; nothing runs on it."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return LogicalMesh(axes, shape)


def make_host_mesh(shape=None, axes=("data", "model"), *,
                   device=None, devices=None) -> LogicalMesh:
    """A mesh for tests and runs: ``shape`` over ``axes`` (default ``(1,
    4)``: every row on the model axis), with a new session over
    ``Topology.full_mesh(model)`` whose devices are the model axis. With
    ``device`` (or neither) the session is stacked on that one device;
    with ``devices`` (one a model index) it is a peer session,
    ``CommSession(devices=devices)``: a *peer mesh*, on which each card
    holds its own logical devices' experts (:func:`~repro_torch.training.
    sharding.place_params`). Passing both raises."""
    from repro_torch.comm.session import CommSession

    if shape is None:
        shape = (1,) * (len(axes) - 1) + (4,)
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    model = dict(zip(axes, shape)).get("model", 1)
    return LogicalMesh(axes, shape, CommSession(
        device=device, devices=devices, topology=Topology.full_mesh(model)))


def is_peer(mesh: LogicalMesh | None) -> bool:
    """Whether ``mesh``'s session puts its logical devices on devices of
    their own (``CommSession(devices=[...])``)."""
    return (mesh is not None and mesh.session is not None
            and mesh.session.devices is not None)


#: The ambient mesh. Process-wide, not per thread: autograd runs a CUDA
#: backward, and so a checkpointed block's recomputation, on a thread of
#: its own, which must see the mesh the forward saw.
_AMBIENT: list[LogicalMesh | None] = [None]


def ambient_mesh() -> LogicalMesh | None:
    """The mesh :func:`set_mesh` made ambient, or None."""
    return _AMBIENT[0]


@contextlib.contextmanager
def set_mesh(mesh: LogicalMesh | None):
    """Make ``mesh`` ambient inside the ``with`` block (None clears it);
    the previous one comes back after."""
    prev = _AMBIENT[0]
    _AMBIENT[0] = mesh
    try:
        yield mesh
    finally:
        _AMBIENT[0] = prev
