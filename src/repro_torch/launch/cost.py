"""The cost count of one call of a step: FLOPs, HBM bytes, collective
records and peak live bytes.

The port's counterpart of a compiler's cost and memory analysis, taken
from the program as it runs. :class:`CostCounter` is a dispatch mode over
one call; it sees every aten op the call issues, under autograd too, and
counts:

* **FLOPs** of the matmul-class ops by ``torch.utils.flop_counter``'s
  formulas, and of each hand-written kernel by its own formula
  (:func:`record_kernel`, called where its wrapper launches it): the
  attention's ``4·D`` for every (query, key) pair its mask keeps
  (:func:`attention_pairs`), its backward 2.5× that, the RWKV-6 scan's
  least float32 work of any chunking (:func:`rwkv6_scan_flops`), none
  for the ring all-gather. Elementwise work is not counted.
* **Bytes**: every input each non-view op reads and every output it
  writes, once each (a stride-0 dimension once; a gather reads the rows it
  takes; an in-place scatter writes the rows it is given); each kernel
  its inputs and outputs once. This is the unfused eager program's HBM
  traffic, which a captured replay repeats.
* **Collectives**: one record ``(op, result_bytes, group)`` for each call
  of a session's collectives (:func:`record_collective`): ``psum`` and
  ``pmean`` as all-reduce, all-gather, reduce-scatter, all-to-all, and a
  send or exchange as collective-permute, with the result's bytes per row
  and the rows as the group.
* **Peak live bytes**: the storages the ops allocate, from allocation
  until they are collected, at their largest sum (the counterpart of a
  compiler's temporary bytes; the arguments live before the call are not
  in it).

The same step counts the same on meta tensors and on CUDA tensors: a
meta tensor takes the card's branch of every wrapper, and a kernel's
wrapper allocates its outputs and records its formula on both, launching
only on the card. Counting on meta is a choice the caller makes
(``device="meta"``), never a fallback.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


@dataclasses.dataclass
class Cost:
    """What one counted call did (see the module docstring)."""

    flops: int = 0
    bytes: int = 0
    collectives: list = dataclasses.field(default_factory=list)
    kernels: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0

    def key(self) -> tuple:
        """Everything counted, for equality between two counts."""
        return (self.flops, self.bytes, tuple(self.collectives),
                tuple(sorted(self.kernels.items())), self.peak_bytes)


#: The counters in force, innermost last. Process-wide, not per thread:
#: autograd runs a CUDA backward on a thread of its own.
_ACTIVE: list["CostCounter"] = []

# ops that move no data (allocations, and an alias outside the schema's
# view annotation)
_NO_TRAFFIC = frozenset({
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::_unsafe_view"})
# in-place ops that write all of self and read none of it
_WRITE_SELF = frozenset({"aten::fill_", "aten::zero_", "aten::copy_"})
# reads: the index and as many of self's elements as the output holds
_GATHERS = frozenset({"aten::index", "aten::index_select", "aten::gather"})
# in-place ops that write only the rows of self they are given (and read
# them too when they accumulate: ``index_put_``'s ``accumulate``)
_SCATTERS = frozenset({"aten::index_copy_", "aten::index_put_"})


def touched_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a dimension of stride 0
    (a broadcast) counts once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or results: a tensor, or a flat
    sequence of tensors and lists of them (as aten's schemas have)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _shapes(x):
    """``x`` with every tensor replaced by its shape, as the flop
    counter's formulas take them (module-level recursion: no reference
    cycle holds the op's tensors, as ``torch.utils._pytree``'s recursive
    closures would until the cyclic collector runs)."""
    if isinstance(x, torch.Tensor):
        return x.shape
    if isinstance(x, (list, tuple)):
        return type(x)(_shapes(v) for v in x)
    return x


def _flops(func, args, kwargs, out) -> int:
    formula = flop_registry.get(func._overloadpacket)
    if formula is None:
        return 0
    raw = getattr(formula, "__wrapped__", None)
    if raw is None:
        return int(formula(*args, **kwargs, out_val=out))
    return int(raw(*_shapes(args), out_shape=_shapes(out),
                   **{k: _shapes(v) for k, v in kwargs.items()}))


def _op_bytes(func, args, kwargs, ins, outs) -> int:
    name = func._schema.name
    if func.is_view or name in _NO_TRAFFIC:
        return 0
    outs = sum(t.numel() * t.element_size() for t in outs)
    if name in _WRITE_SELF:
        return sum(touched_bytes(t) for t in ins[1:]) + outs
    if name in _GATHERS:
        index = [t for t in ins if not t.is_floating_point()
                 and t is not ins[0]]
        return sum(touched_bytes(t) for t in index) + 2 * outs
    if name in _SCATTERS:
        accumulate = name == "aten::index_put_" and bool(
            args[3] if len(args) > 3 else kwargs.get("accumulate", False))
        rest = ins[1:]
        src = touched_bytes(rest[-1]) if rest else 0
        return (sum(touched_bytes(t) for t in rest) + src
                + (src if accumulate else 0))
    return sum(touched_bytes(t) for t in ins) + outs


class CostCounter(TorchDispatchMode):
    """Counts one call (``with CostCounter() as c: ...``; then
    ``c.cost``). Counters nest; kernels and collectives report to the
    innermost."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live: dict[int, int] = {}
        self._live_bytes = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, ins, outs) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self._live_bytes += st.nbytes()
            self.cost.peak_bytes = max(self.cost.peak_bytes,
                                       self._live_bytes)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost.flops += _flops(func, args, kwargs, out)
        ins = _tensors(args) + _tensors(
            [v for k, v in kwargs.items() if k != "out"])
        outs = _tensors(out if isinstance(out, (list, tuple)) else [out])
        self.cost.bytes += _op_bytes(func, args, kwargs, ins, outs)
        if not func.is_view:
            self._track(ins + _tensors(kwargs.get("out", ())), outs)
        return out


def active() -> CostCounter | None:
    """The innermost counter in force, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Cost)`` of one call."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost


def record_kernel(name: str, flops: int, inputs, outputs) -> None:
    """A hand-written kernel's call: ``flops`` by its formula, each of
    ``inputs`` read once and each of ``outputs`` written once (None
    entries skipped). Called by its wrapper on the card and on meta
    alike; a no-op with no counter in force."""
    c = active()
    if c is None:
        return
    c.cost.flops += int(flops)
    c.cost.bytes += sum(touched_bytes(t) for t in inputs if t is not None)
    c.cost.bytes += sum(t.numel() * t.element_size() for t in outputs
                        if t is not None)
    c.cost.kernels[name] = c.cost.kernels.get(name, 0) + 1


def record_collective(op: str, result_bytes: int, group: int) -> None:
    """One collective call: ``op`` (a roofline op kind), its result's
    bytes per row and the rows it runs over. A no-op with no counter in
    force."""
    c = active()
    if c is not None:
        c.cost.collectives.append((op, int(result_bytes), int(group)))


def stacked_collective(op: str, xs) -> None:
    """:func:`record_collective` of a collective over a device-stacked
    ``(n, ...)`` operand, or a per-device list of ``n`` rows (a peer
    session's): all-gather's result per row is ``n`` rows,
    reduce-scatter's ``1 / n`` of one, the others one row."""
    n = len(xs)
    row = xs[0].numel() * xs[0].element_size() if n else 0
    if op == "all-gather":
        row *= n
    elif op == "reduce-scatter":
        row //= n
    record_collective(op, row, n)


class CountingCollectives:
    """The collectives a model layer calls (the MoE combine's psum and its
    FSDP weight gather) for a mesh with no session (the production mesh),
    in a count of meta tensors: each call is recorded as the session's
    would be and returns a new meta tensor of its result's shape; no
    composition runs."""

    def _run(self, op: str, xs: torch.Tensor, shape) -> torch.Tensor:
        if xs.device.type != "meta":
            raise ValueError(f"a sessionless mesh's collectives count meta "
                             f"tensors only, got {xs.device}")
        stacked_collective(op, xs)
        return xs.new_empty(shape)

    def psum(self, xs):
        return self._run("all-reduce", xs, xs.shape)

    def all_gather(self, xs):
        n = xs.shape[0]
        return self._run("all-gather", xs,
                         (n, n * xs.shape[1]) + tuple(xs.shape[2:]))


# -- the kernels' formulas ------------------------------------------------------

def attention_pairs(s: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs of one ``(S, S)`` head the mask keeps:
    causal ``col <= row``, a window ``col > row - window``."""
    if window is None or window >= s:
        return s * (s + 1) // 2 if causal else s * s
    w = window
    if causal:        # min(row + 1, w) a row
        return w * (w + 1) // 2 + (s - w) * w
    return s * s - (s - w) * (s - w + 1) // 2   # S - max(0, row - w + 1)


def attention_flops(b: int, hq: int, s: int, d: int, causal: bool,
                    window: int | None) -> int:
    """The attention kernel's FLOPs: ``4·D`` (Q·Kᵀ and P·V) for every
    pair the mask keeps, over ``B·Hq`` heads."""
    return 4 * b * hq * d * attention_pairs(s, causal, window)


def attention_bwd_flops(b: int, hq: int, s: int, d: int, causal: bool,
                        window: int | None) -> int:
    """The backward's FLOPs: 2.5 × the forward's (S and dP again, dV, dQ,
    dK: five products for the forward's two)."""
    return attention_flops(b, hq, s, d, causal, window) * 5 // 2


def _least(per_position, s: int) -> float:
    """``per_position(c)`` at the chunk ``c`` in ``1..s`` that needs least
    (the function falls, then rises)."""
    best = per_position(1)
    for c in range(2, s + 1):
        v = per_position(c)
        if v > best:
            break
        best = v
    return best


def rwkv6_scan_flops(b: int, s: int, h: int, dk: int, dv: int) -> int:
    """The scan's least float32 work of any chunking: q̃·S and the state
    update, ``4·dk·dv`` a position, plus in chunks of c the strictly
    causal scores ``(c - 1)·dk``, P·V with the bonus diagonal ``(c +
    1)·dv`` and the state's decay once a chunk ``dk·dv / c``."""
    return round(b * h * s * _least(
        lambda c: 4 * dk * dv + (c - 1) * dk + (c + 1) * dv + dk * dv / c,
        s))


def rwkv6_scan_bwd_flops(b: int, s: int, h: int, dk: int, dv: int) -> int:
    """The backward's least float32 work of any chunking: FMAs a position
    in chunks of c, the four ``dk·dv`` products, the strictly causal A,
    dA·k̃ and dAᵀ·q̃ (``(c - 1) / 2`` each over dk) and dA (over dv),
    Aᵀ·dO with its diagonal (``(c + 1) / 2`` over dv) and G's decay once
    a chunk; two FLOPs an FMA."""
    return round(2 * b * h * s * _least(
        lambda c: (4 * dk * dv + (c - 1) / 2 * (3 * dk + dv)
                   + (c + 1) / 2 * dv + dk * dv / c), s))
