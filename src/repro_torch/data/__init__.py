"""Deterministic synthetic data and a prefetching loader."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, PrefetchLoader, SyntheticDataset, batch_to)
