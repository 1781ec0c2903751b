"""Checkpointing with async save, integrity hashes and keep-last-k.

The counterpart of the reference's ``repro/checkpoint/manager.py``, with
the same on-disk layout, so a checkpoint written by either package
restores in the other:

* one ``.npy`` per leaf, named by its keys joined with ``"__"``, leaves in
  sorted-key order (the order the reference flattens dicts in);
* ``index.json`` holding the step, each leaf's file, path, shape, dtype
  name and sha256, the metadata and the time of the save;
* the directory ``step_N`` written as ``step_N.tmp`` and renamed when
  complete.

bfloat16 leaves are stored as the reference stores them: the raw 16-bit
patterns under the numpy descr ``'<V2'``, with ``"bfloat16"`` as the
index's dtype. The port writes and reads those bytes itself (no numpy
extension type is needed), and its files are byte for byte the
reference's.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, unflatten

_INDEX = "index.json"
_BF16_DESCR = "<V2"


def _leaf_name(path: tuple) -> str:
    return "__".join(str(p) for p in path) or "leaf"


def _sha256(fn: str) -> str:
    h = hashlib.sha256()
    with open(fn, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def to_host(t) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its dtype name; a bfloat16
    tensor becomes its 16-bit patterns (int16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(t)
    return arr, str(arr.dtype)


def _save_leaf(fn: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(fn, arr)
        return
    with open(fn, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_leaf(fn: str, dtype: str) -> torch.Tensor:
    arr = np.load(fn)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def save_checkpoint(directory: str, step: int, state, *,
                    metadata: dict | None = None) -> str:
    """Write ``state`` (nested dicts of tensors or arrays) atomically to
    ``directory/step_N``; returns that path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for path, leaf in leaves_with_paths(state):
        name = _leaf_name(path) + ".npy"
        arr, dtype = to_host(leaf)
        _save_leaf(os.path.join(tmp, name), arr, dtype)
        entries.append({"name": name, "path": _leaf_name(path),
                        "shape": list(arr.shape), "dtype": dtype,
                        "sha256": _sha256(os.path.join(tmp, name))})
    index = {"step": step, "leaves": entries,
             "metadata": metadata or {}, "saved_at": time.time()}
    with open(os.path.join(tmp, _INDEX), "w") as f:
        json.dump(index, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in sorted(os.listdir(directory)):
        if d.startswith("step_") and not d.endswith(".tmp"):
            full = os.path.join(directory, d)
            if os.path.exists(os.path.join(full, _INDEX)):
                out.append((int(d.split("_")[1]), full))
    return sorted(out)


def latest_checkpoint(directory: str) -> str | None:
    cps = list_checkpoints(directory)
    return cps[-1][1] if cps else None


def restore_checkpoint(path: str, like, *, device=None,
                       verify: bool = True):
    """Restore into the structure of ``like`` (nested dicts of tensors,
    meta tensors included, or arrays); leaves come back as tensors on
    ``device`` (the CPU by default) in the dtype the file holds. Returns
    ``(state, step, metadata)``. A leaf whose sha256 differs from the
    index raises ``IOError``; a shape that differs from ``like``'s raises
    ``ValueError``."""
    with open(os.path.join(path, _INDEX)) as f:
        index = json.load(f)
    by_path = {e["path"]: e for e in index["leaves"]}
    out = []
    for p, leaf in leaves_with_paths(like):
        entry = by_path[_leaf_name(p)]
        fn = os.path.join(path, entry["name"])
        if verify and _sha256(fn) != entry["sha256"]:
            raise IOError(f"checkpoint corruption detected in {fn}")
        t = _load_leaf(fn, entry["dtype"])
        if list(t.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {entry['path']}: "
                             f"ckpt {tuple(t.shape)} vs expected "
                             f"{tuple(leaf.shape)}")
        out.append(t.to(device) if device is not None else t)
    return unflatten(like, out), index["step"], index["metadata"]


class CheckpointManager:
    """keep-last-k manager with optional async (background-thread) saves."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state, metadata: dict | None = None):
        """Copy ``state`` to the host now (a synchronizing copy), write it
        on a background thread (or here without ``async_save``)."""
        host_state = _host_tree(state)

        def _do():
            try:
                save_checkpoint(self.directory, step, host_state,
                                metadata=metadata)
                self._gc()
            except BaseException as exc:  # re-raised by wait()
                self._error = exc

        self.wait()
        if self.async_save:
            self._pending = threading.Thread(target=_do, daemon=True)
            self._pending.start()
        else:
            _do()
            self.wait()

    def wait(self):
        """Join the pending save; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def _gc(self):
        cps = list_checkpoints(self.directory)
        for step, path in cps[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    def restore_latest(self, like, device=None):
        self.wait()
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        return restore_checkpoint(path, like, device=device)


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.asarray(tree)
