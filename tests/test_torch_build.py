"""The kernel build's cache key, on the CPU (no ``nvcc`` needed).

A built library's file name carries a hash of everything in the kernel's
``csrc/`` and of the flags (``repro_torch.kernels._build._target``), so a
changed header or flag can never load a stale library.
"""

import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def kernel_tree(tmp_path, monkeypatch):
    """A copy of the kernels' ``csrc/`` trees under a temporary
    ``KERNEL_DIR``, and a build directory beside it."""
    for name in _build.KERNELS:
        src = _build.csrc_dir(name)
        dst = tmp_path / "kernels" / src.parent.name / "csrc"
        if not dst.exists():
            shutil.copytree(src, dst)
    monkeypatch.setattr(_build, "KERNEL_DIR", tmp_path / "kernels")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    return tmp_path / "kernels"


@pytest.mark.parametrize("name", _build.KERNELS)
def test_target_changes_with_a_header(kernel_tree, name):
    before = _build._target(name)
    assert before.parent == kernel_tree.parent / "build"
    assert _build._target(name) == before
    header = _build.csrc_dir(name) / "extra.cuh"
    assert header.parent.parent.parent == kernel_tree
    header.write_text("// a header beside the source\n")
    added = _build._target(name)
    assert added != before
    header.write_text("// the same header, edited\n")
    edited = _build._target(name)
    assert edited not in (before, added)
    header.unlink()
    assert _build._target(name) == before


def test_target_changes_with_the_source_and_flags(kernel_tree, monkeypatch):
    name = "flash_attention"
    before = _build._target(name)
    src = _build.source_path(name)
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build._target(name) != before
    src.write_bytes(src.read_bytes()[:-1])
    assert _build._target(name) == before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lcuda",))
    assert _build._target(name) != before


def test_targets_differ_per_kernel(kernel_tree):
    targets = {_build._target(name) for name in _build.KERNELS}
    assert len(targets) == len(_build.KERNELS)
