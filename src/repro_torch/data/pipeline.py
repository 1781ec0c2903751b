"""Synthetic, deterministic data pipeline.

The counterpart of the reference's ``repro/data/pipeline.py``. Batches are
LM batches (tokens/labels/mask) or audio-frontend batches
(features/labels) whose content is a pure function of ``(seed, step)``,
made with numpy's ``RandomState`` exactly as the reference makes them, so
both packages train on bitwise the same stream and a restarted job
replays it from its checkpointed step. A background thread keeps
``prefetch`` batches ahead of the loop and moves them to a device (from
pinned host memory with ``non_blocking`` copies on a CUDA device).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic LM task: token t+1 = (a*t + b) mod vocab on easy positions,
    # noise elsewhere — learnable but non-trivial.
    noise_prob: float = 0.2


class SyntheticDataset:
    """Deterministic synthetic stream for an architecture."""

    def __init__(self, cfg: ArchConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step) → numpy batch."""
        d, c = self.data, self.cfg
        rng = np.random.RandomState((d.seed * 1_000_003 + step) % 2**31)
        b, s = d.global_batch, d.seq_len
        if c.frontend == "audio":
            feats = rng.randn(b, s, c.frontend_dim).astype(np.float32)
            labels = rng.randint(0, c.vocab_size, (b, s)).astype(np.int32)
            return {"features": feats, "labels": labels,
                    "mask": np.ones((b, s), np.float32)}
        vocab = c.vocab_size
        a = rng.randint(1, min(vocab, 641))
        start = rng.randint(0, vocab, (b, 1))
        seq = (start + a * np.arange(s + 1)[None, :]) % vocab
        noise = rng.rand(b, s + 1) < d.noise_prob
        seq = np.where(noise, rng.randint(0, vocab, (b, s + 1)), seq)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32),
                "mask": np.ones((b, s), np.float32)}

    def iter_batches(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def batch_to(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``, dtypes kept (tokens and
    labels int32, as the reference's; an audio batch's features float32).
    On a CUDA device the copies leave pinned host memory without
    blocking."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if cuda:
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=cuda)
    return out


class PrefetchLoader:
    """Background-thread prefetcher with device placement: yields
    ``(step, batch)`` in step order, the batch as tensors on ``device``
    (numpy arrays when ``device`` is None)."""

    def __init__(self, dataset: SyntheticDataset, device=None,
                 start_step: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch_at(step)
            if self.device is not None:
                batch = batch_to(batch, self.device)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=1.0)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
