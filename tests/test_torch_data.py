"""The port's synthetic data pipeline against the reference's.

Both packages draw a batch from numpy's ``RandomState`` seeded by
``(seed, step)``, so the batches must be bitwise equal: LM batches and
audio-frontend batches, at several seeds and steps. The prefetching
loader yields steps in order, each batch equal to ``batch_at(step)``, on
the device it was given.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JSyntheticDataset

from repro_torch.configs import get_config
from repro_torch.data import (DataConfig, PrefetchLoader, SyntheticDataset,
                              batch_to)


def datasets(arch, seq, batch, seed, audio=False):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if audio:
        jcfg = dataclasses.replace(jcfg, frontend="audio", frontend_dim=24)
        cfg = dataclasses.replace(cfg, frontend="audio", frontend_dim=24)
    return (JSyntheticDataset(jcfg, JDataConfig(seq, batch, seed)),
            SyntheticDataset(cfg, DataConfig(seq, batch, seed)))


@pytest.mark.parametrize("arch", ["smollm_360m", "llama3_8b"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("audio", [False, True])
def test_batches_bitwise(arch, seed, audio):
    jds, ds = datasets(arch, 33, 4, seed, audio)
    for step in (0, 1, 17, 1000):
        want, got = jds.batch_at(step), ds.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), (k, step)


def test_iter_batches_from_a_start_step():
    _, ds = datasets("smollm_360m", 8, 2, 3)
    it = ds.iter_batches(5)
    for step in (5, 6, 7):
        b = next(it)
        assert np.array_equal(b["tokens"], ds.batch_at(step)["tokens"])


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetch_order(device):
    _, ds = datasets("smollm_360m", 16, 4, 1)
    loader = PrefetchLoader(ds, device=device, start_step=3, prefetch=2)
    try:
        for want_step in range(3, 10):
            step, batch = next(loader)
            assert step == want_step
            ref = ds.batch_at(step)
            for k, v in batch.items():
                if device is None:
                    assert isinstance(v, np.ndarray)
                    got = v
                else:
                    assert v.device.type == "cpu"
                    got = v.numpy()
                assert np.array_equal(got, ref[k])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_batch_to_keeps_dtypes():
    _, ds = datasets("smollm_360m", 8, 2, 0)
    b = batch_to(ds.batch_at(0), "cpu")
    assert b["tokens"].dtype == torch.int32
    assert b["labels"].dtype == torch.int32
    assert b["mask"].dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 7])
def test_hubert_batches_bitwise(seed):
    """The registered audio encoder's own batches (HuBERT-XLarge: 512-dim
    frame features, a unit label in 504 per frame) equal the reference's
    bit for bit, and the prefetching loader hands its features over as
    float32 tensors on its device."""
    jds = JSyntheticDataset(jget_config("hubert_xlarge"),
                            JDataConfig(40, 2, seed))
    ds = SyntheticDataset(get_config("hubert_xlarge"),
                          DataConfig(40, 2, seed))
    for step in (0, 3):
        want, got = jds.batch_at(step), ds.batch_at(step)
        assert sorted(got) == sorted(want) == ["features", "labels", "mask"]
        assert got["features"].shape == (2, 40, 512)
        assert got["labels"].max() < 504
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), (k, step)
    loader = PrefetchLoader(ds, device="cpu", start_step=3, prefetch=1)
    try:
        step, batch = next(loader)
    finally:
        loader.close()
    assert step == 3 and batch["features"].dtype == torch.float32
    assert np.array_equal(batch["features"].numpy(),
                          jds.batch_at(3)["features"])
