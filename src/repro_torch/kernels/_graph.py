"""Resident programs replayed as one CUDA graph, and the launch counters.

Every executable that :class:`~repro_torch.comm.cache.CompiledPlan` serves
is a :class:`GraphProgram`: static buffers plus a body (:meth:`run`) that
executes once. On a CUDA device :meth:`GraphProgram.capture` records one
run into a ``torch.cuda.CUDAGraph`` (one a card for a program over peer
cards) and :meth:`GraphProgram.replay` launches it; on the CPU
:meth:`~GraphProgram.replay` runs the body eagerly, with the kernels'
plain versions.

Each kernel module counts its launches in ``LAUNCHES``, where its wrapper
launches the kernel. A launch made while a graph is being captured is only
recorded, not run: :meth:`GraphProgram.capture` takes it off the counter
again and adds it back on every replay, so the counters say how often each
kernel really ran.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable

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
    and :meth:`outputs`. A program whose executions span several cards
    lists them in :attr:`cards`, gives one body a card (:meth:`bodies`,
    recorded as one graph each) and orders the cards before each
    execution (:meth:`order`). ``replay_launches`` holds the kernel
    launches one replay makes (empty before :meth:`capture`), and
    ``held_bytes`` the device memory that the graphs' pools keep (0
    before it, and on the CPU).
    """

    device: torch.device
    #: (card, instantiated graph), one a body (empty before recording).
    _graphs: list[tuple[torch.device, torch.cuda.CUDAGraph]] = []
    replay_launches: dict[str, int] = {}
    held_bytes: int = 0

    @property
    def cards(self) -> tuple[torch.device, ...]:
        """The devices an execution runs on: the program's one device by
        default."""
        return (self.device,)

    def synchronize(self) -> None:
        """Wait for every CUDA card of the program."""
        for card in self.cards:
            if card.type == "cuda":
                torch.cuda.synchronize(card)

    def run(self) -> None:
        """Execute the body once, without a graph."""
        raise NotImplementedError

    def bodies(self) -> list[tuple[torch.device, Callable[[], None]]]:
        """(card, body) pairs, each recorded into one graph of its card:
        the whole :meth:`run` on the program's device by default."""
        return [(self.device, self.run)]

    def order(self) -> None:
        """Order one execution across the program's cards before it runs
        or is replayed: every card's stream waits for what every other
        card has enqueued so far (the previous execution, its result
        copies and this one's staging); nothing to do on one card."""
        cards = self.cards
        if len(cards) < 2:
            return
        if not getattr(self, "_order_events", None):
            self._order_events = [torch.cuda.Event() for _ in cards]
        streams = [torch.cuda.current_stream(c) for c in cards]
        for ev, s in zip(self._order_events, streams):
            ev.record(s)
        for i, s in enumerate(streams):
            for j, ev in enumerate(self._order_events):
                if i != j:
                    s.wait_event(ev)

    def inputs(self) -> list[torch.Tensor]:
        raise NotImplementedError

    def outputs(self) -> list[torch.Tensor]:
        raise NotImplementedError

    def capture(self) -> tuple[int, int]:
        """Warm up once, record one run into CUDA graphs and instantiate
        them. Returns ``(warm-up + capture ns, instantiation ns)``."""
        t0 = time.perf_counter_ns()
        self.run()
        warm_ns = time.perf_counter_ns() - t0
        capture_ns, instantiate_ns = self.record()
        return warm_ns + capture_ns, instantiate_ns

    def record(self) -> tuple[int, int]:
        """Record each of :meth:`bodies` into a CUDA graph of its card and
        instantiate them; the body must have run once before, as the
        warm-up. Recording runs nothing, and a body that cannot be
        captured raises. A program over several cards records each body
        on a stream of its own card. Sets ``held_bytes``, the device
        memory of the graphs' private pools. Returns ``(capture ns,
        instantiation ns)``."""
        t0 = time.perf_counter_ns()
        cards = self.cards
        for card in cards:
            torch.cuda.synchronize(card)
        torch.cuda.empty_cache()
        reserved = sum(torch.cuda.memory_reserved(c) for c in cards)
        before = launch_counts()
        graphs = []
        for card, body in self.bodies():
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            stream = torch.cuda.Stream(card) if len(cards) > 1 else None
            with torch.cuda.device(card), torch.cuda.graph(graph,
                                                           stream=stream):
                body()
            graphs.append((card, graph))
        recorded = {name: k - before[name]
                    for name, k in launch_counts().items()
                    if k != before[name]}
        add_launches({name: -k for name, k in recorded.items()})
        t1 = time.perf_counter_ns()
        for card, graph in graphs:
            with torch.cuda.device(card):
                graph.instantiate()
        self._graphs = graphs
        self.replay_launches = recorded
        self.held_bytes = sum(torch.cuda.memory_reserved(c)
                              for c in cards) - reserved
        return t1 - t0, time.perf_counter_ns() - t1

    def replay(self) -> None:
        """One execution: replay the captured graphs (CUDA; ordered
        across cards first) or run the body (CPU, or before
        :meth:`capture`)."""
        if not self._graphs:
            self.run()
            return
        self.order()
        for card, graph in self._graphs:
            with torch.cuda.device(card):
                graph.replay()
        add_launches(self.replay_launches)
