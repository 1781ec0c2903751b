"""State carried across from the reference package.

The communication layer's state is the machine model and the
configuration: :func:`topology_from_spec` and :func:`config_from_dict`
rebuild them from plain dictionaries (no import of the reference), and
:func:`topology_spec` writes a topology out as one, so a topology or a
config written out on one side is the same object on the other —
:meth:`~repro_torch.core.topology.Topology.digest` equality is the check.

The models' state is their weights and decode caches: nested dicts of
numpy arrays in the reference's layout (``embed``, ``layers/{ln1, ln2,
attn/{wq, wk, wv, wo}, mlp/{w1, w2, w3}}``, ``final_norm``, ``lm_head``;
a cache's ``k`` and ``v``) become the port's tensors with
:func:`params_from_numpy` and :func:`cache_from_numpy`, and a train state
(parameters, AdamW moments and step) with :func:`state_from_numpy`, so
both packages compute with the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.comm.config import CommConfig
from repro_torch.core.topology import Link, Topology


def topology_spec(topology) -> dict[str, Any]:
    """The plain-dict state of a topology — of this package or any object
    with the same attributes — as :func:`topology_from_spec` takes it:
    the nominal links in registration order (route enumeration visits
    them in that order), the island assignment and the grid."""
    return {"num_devices": topology.num_devices, "name": topology.name,
            "grid_shape": topology.grid_shape,
            "node_assignment": [topology.node_of(d)
                                for d in range(topology.num_devices)],
            "links": [(ln.src, ln.dst, ln.kind, ln.bandwidth_gbps)
                      for ln in topology.links.values()]}


def topology_from_spec(spec: Mapping[str, Any]) -> Topology:
    """Build a :class:`Topology` from ``{"num_devices", "name",
    "grid_shape", "node_assignment", "links"}``, where ``links`` holds
    ``(src, dst, kind, gbps)`` tuples (the nominal link set; repeated
    pairs aggregate as sublinks)."""
    grid = spec.get("grid_shape")
    return Topology(
        int(spec["num_devices"]),
        [Link(int(s), int(d), str(k), float(bw))
         for s, d, k, bw in spec["links"]],
        name=spec.get("name", "custom"),
        grid_shape=tuple(grid) if grid is not None else None,
        node_assignment=spec.get("node_assignment"))


def config_from_dict(d: Mapping[str, Any]) -> CommConfig:
    """Build a :class:`CommConfig` from its field values; unknown keys
    raise ``TypeError``."""
    names = {f.name for f in dataclasses.fields(CommConfig)}
    unknown = set(d) - names
    if unknown:
        raise TypeError(f"unknown CommConfig fields {sorted(unknown)}")
    return CommConfig(**dict(d))


def tensor_from_numpy(a, *, device=None) -> torch.Tensor:
    """One array (anything ``np.asarray`` takes) as a tensor on ``device``
    with its own dtype. A bfloat16 array (numpy's extension type, which
    ``torch.from_numpy`` rejects) is reinterpreted bit for bit through
    16-bit integers."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree, *, device=None):
    """A model's parameters — nested dicts (and lists) of arrays in the
    reference's layout, layers stacked on a leading ``L`` axis, an audio
    model's ``frontend_proj`` and ``head`` beside them — as the same
    structure of tensors on ``device``, dtypes kept (bfloat16
    included)."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device=device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device=device) for v in tree)
    return tensor_from_numpy(tree, device=device)


#: A decode cache (``{"k", "v"}`` arrays, ``(L, B, Hkv, ...)``) carries
#: across the same way.
cache_from_numpy = params_from_numpy


def state_from_numpy(state, *, device=None) -> dict:
    """A reference train state ``{"params", "opt": {"m", "v", "step"}}``
    as numpy arrays (int8 moments as ``{"q", "scale"}``) → the port's
    tensors on ``device``, dtypes kept; ``step`` a 0-d int32 tensor."""
    opt = state["opt"]
    return {"params": params_from_numpy(state["params"], device=device),
            "opt": {"m": params_from_numpy(opt["m"], device=device),
                    "v": params_from_numpy(opt["v"], device=device),
                    "step": tensor_from_numpy(
                        np.asarray(opt["step"], np.int32), device=device)}}
