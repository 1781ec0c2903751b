"""Resident programs replayed as one CUDA graph, and the launch counters.

Every executable that :class:`~repro_torch.comm.cache.CompiledPlan` serves
is a :class:`GraphProgram`: static buffers plus a body (:meth:`run`) that
executes once. On a CUDA device :meth:`GraphProgram.capture` records one
run into a ``torch.cuda.CUDAGraph`` and :meth:`GraphProgram.replay`
launches it; on the CPU :meth:`~GraphProgram.replay` runs the body
eagerly, with the kernels' plain versions.

Each kernel module counts its launches in ``LAUNCHES``, where its wrapper
launches the kernel. A launch made while a graph is being captured is only
recorded, not run: :meth:`GraphProgram.capture` takes it off the counter
again and adds it back on every replay, so the counters say how often each
kernel really ran.
"""

from __future__ import annotations

import importlib
import time

import torch

from repro_torch.kernels import _build


#: Kernel name → (kernel module, counter) where it is not
#: ``<name>.kernel.LAUNCHES``.
_COUNTERS = {"flash_attention_bwd": ("flash_attention", "LAUNCHES_BWD"),
             "rwkv6_scan_bwd": ("rwkv6_scan", "LAUNCHES_BWD")}


def _counter(name: str):
    module, attr = _COUNTERS.get(name, (name, "LAUNCHES"))
    return (importlib.import_module(f"repro_torch.kernels.{module}.kernel"),
            attr)


def launch_counts() -> dict[str, int]:
    """Kernel name → launches so far, for every kernel of the port."""
    return {name: getattr(*_counter(name)) for name in _build.KERNELS}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for name in _build.KERNELS:
        setattr(*_counter(name), 0)


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name → launches) to the counters."""
    for name, k in counts.items():
        module, attr = _counter(name)
        setattr(module, attr, getattr(module, attr) + k)


class GraphProgram:
    """Static buffers and a body run once per execution.

    Subclasses set ``device`` and implement :meth:`run`, :meth:`inputs`
    and :meth:`outputs`. ``replay_launches`` holds the kernel launches one
    replay of the captured graph makes (empty before :meth:`capture`), and
    ``held_bytes`` the device memory that the graph's pool keeps (0 before
    it, and on the CPU).
    """

    device: torch.device
    _graph: torch.cuda.CUDAGraph | None = None
    replay_launches: dict[str, int] = {}
    held_bytes: int = 0

    def run(self) -> None:
        """Execute the body once, without a graph."""
        raise NotImplementedError

    def inputs(self) -> list[torch.Tensor]:
        raise NotImplementedError

    def outputs(self) -> list[torch.Tensor]:
        raise NotImplementedError

    def capture(self) -> tuple[int, int]:
        """Warm up once, record one run into a CUDA graph and instantiate
        it. Returns ``(warm-up + capture ns, instantiation ns)``."""
        t0 = time.perf_counter_ns()
        self.run()
        warm_ns = time.perf_counter_ns() - t0
        capture_ns, instantiate_ns = self.record()
        return warm_ns + capture_ns, instantiate_ns

    def record(self) -> tuple[int, int]:
        """Record one run into a CUDA graph and instantiate it; the body
        must have run once before, as the warm-up. Recording runs nothing,
        and a body that cannot be captured raises. Sets ``held_bytes``,
        the device memory of the graph's private pool. Returns ``(capture
        ns, instantiation ns)``."""
        t0 = time.perf_counter_ns()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = launch_counts()
        with torch.cuda.graph(graph):
            self.run()
        recorded = {name: k - before[name]
                    for name, k in launch_counts().items()
                    if k != before[name]}
        add_launches({name: -k for name, k in recorded.items()})
        t1 = time.perf_counter_ns()
        graph.instantiate()
        self._graph = graph
        self.replay_launches = recorded
        self.held_bytes = torch.cuda.memory_reserved(self.device) - reserved
        return t1 - t0, time.perf_counter_ns() - t1

    def replay(self) -> None:
        """One execution: replay the captured graph (CUDA) or run the body
        (CPU, or before :meth:`capture`)."""
        if self._graph is None:
            self.run()
            return
        self._graph.replay()
        add_launches(self.replay_launches)
