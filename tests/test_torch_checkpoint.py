"""The port's checkpoints against the reference's on-disk layout.

A checkpoint holding float32, bfloat16 and int8-moment leaves written by
the reference restores bitwise in the port, and one written by the port
is byte for byte the reference's (the same files, the same sha256 in the
index) and restores in the reference. The reference's own restore cannot
read its bfloat16 leaves (``np.load`` gives a ``'<V2'`` array, which it
cannot turn into an array of its own), so the reverse is checked by
file bytes for every leaf and by the reference's restore for the others.
Corruption is detected; the manager keeps the last k.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import restore_checkpoint as jrestore
from repro.checkpoint.manager import save_checkpoint as jsave

from repro_torch.carry import state_from_numpy
from repro_torch.checkpoint import (CheckpointManager, latest_checkpoint,
                                    list_checkpoints, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.tree import leaves, tree_map


def reference_state():
    rs = np.random.RandomState(0)
    p = {"embed": jnp.asarray(rs.randn(16, 8), jnp.bfloat16),
         "layers": {"w": jnp.asarray(rs.randn(2, 8, 4), jnp.float32),
                    "ln": jnp.asarray(rs.randn(2, 8), jnp.float32)}}
    q = lambda x: {"q": jnp.asarray(rs.randint(-127, 128, x.shape),
                                    jnp.int8),
                   "scale": jnp.float32(rs.rand())}
    return {"params": p,
            "opt": {"m": jax.tree.map(q, p), "v": jax.tree.map(q, p),
                    "step": jnp.int32(7)}}


def port_state(jstate):
    return state_from_numpy(jax.tree.map(np.asarray, jstate))


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path):
    jstate = reference_state()
    path = jsave(str(tmp_path), 7, jstate, metadata={"loss": 1.5})
    like = port_state(jstate)
    state, step, meta = restore_checkpoint(path, like)
    assert step == 7 and meta == {"loss": 1.5}
    for a, b in zip(leaves(like), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))
    assert state["params"]["embed"].dtype == torch.bfloat16


def test_port_checkpoint_is_the_reference_files(tmp_path):
    jstate = reference_state()
    jpath = jsave(str(tmp_path / "ref"), 3, jstate)
    path = save_checkpoint(str(tmp_path / "port"), 3, port_state(jstate))
    assert os.path.basename(path) == os.path.basename(jpath)
    jindex = json.load(open(os.path.join(jpath, "index.json")))
    index = json.load(open(os.path.join(path, "index.json")))
    strip = lambda ix: [{k: v for k, v in e.items()} for e in ix["leaves"]]
    assert strip(index) == strip(jindex)
    for e in index["leaves"]:
        with open(os.path.join(path, e["name"]), "rb") as f, \
                open(os.path.join(jpath, e["name"]), "rb") as g:
            assert f.read() == g.read(), e["name"]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """Every leaf but the bfloat16 one through the reference's restore
    (it cannot read its own bfloat16 files); that one by its bits."""
    jstate = reference_state()
    path = save_checkpoint(str(tmp_path), 5, port_state(jstate))
    no_bf16 = dict(jstate, params={"layers": jstate["params"]["layers"]})
    no_bf16["opt"] = dict(jstate["opt"])
    restored, step, _ = jrestore(path, no_bf16)
    assert step == 5
    for a, b in zip(jax.tree.leaves(no_bf16), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b))
    raw = np.load(os.path.join(path, "params__embed.npy"))
    want = np.asarray(jstate["params"]["embed"]).view(np.int16)
    assert np.array_equal(raw.view(np.int16), want)


def test_corruption_detection(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, port_state(reference_state()))
    victim = os.path.join(path, "params__layers__w.npy")
    with open(victim, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(path, port_state(reference_state()))


def test_shape_mismatch_raises(tmp_path):
    state = port_state(reference_state())
    path = save_checkpoint(str(tmp_path), 1, state)
    like = tree_map(lambda t: t, state)
    like["params"]["layers"]["w"] = torch.zeros(3, 8, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(path, like)


@pytest.mark.parametrize("async_save", [True, False])
def test_keep_last_k(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    state = port_state(reference_state())
    for s in (10, 20, 30):
        mgr.save(s, state, metadata={"s": s})
    mgr.wait()
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [20, 30]
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000030")
    restored, step, meta = mgr.restore_latest(
        tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                       device="meta"), state))
    assert step == 30 and meta == {"s": 30}
    for a, b in zip(leaves(state), leaves(restored)):
        assert torch.equal(bits(a), bits(b))


def test_save_copies_before_the_caller_mutates(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=True)
    state = {"w": torch.ones(4)}
    mgr.save(1, state)
    state["w"].add_(1.0)
    mgr.wait()
    restored, _, _ = mgr.restore_latest({"w": torch.empty(4)})
    assert torch.equal(restored["w"], torch.ones(4))
