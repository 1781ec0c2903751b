"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel's source lives in ``kernels/<name>/csrc/<name>.cu`` (each
backward's beside its forward's, in ``flash_attention/csrc/`` and
``rwkv6_scan/csrc/``)
and exposes a plain C interface. It is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library at first
use, under ``build/repro_torch/`` at the root of the checkout (or
``$REPRO_TORCH_BUILD_DIR``). The library's file name carries a hash of
every file in the kernel's ``csrc/`` (a header too) and of the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source, all at once. A failed
build raises; nothing falls back to the plain versions.

The cache of loaded libraries here and each kernel module's launch
counter are the package's only global state.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("multipath_dma", "jacobi", "ring_allgather", "flash_attention",
           "flash_attention_bwd", "rwkv6_scan", "rwkv6_scan_bwd")
#: A kernel whose source sits in another kernel's ``csrc/``.
_DIRS = {"flash_attention_bwd": "flash_attention",
         "rwkv6_scan_bwd": "rwkv6_scan"}

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """Where the shared libraries go: ``$REPRO_TORCH_BUILD_DIR`` or
    ``build/repro_torch`` beside ``src/`` in the checkout."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return KERNEL_DIR.parents[2] / "build" / "repro_torch"


def csrc_dir(name: str) -> Path:
    """The ``csrc/`` directory that holds kernel ``name``'s source."""
    return KERNEL_DIR / _DIRS.get(name, name) / "csrc"


def source_path(name: str) -> Path:
    return csrc_dir(name) / f"{name}.cu"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return found


def _target(name: str) -> Path:
    """The library's path: its name carries a hash of every file in the
    kernel's ``csrc/`` (names and contents, in sorted order) and of the
    flags, so an edited header or flag is a new build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    csrc = csrc_dir(name)
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(csrc)).encode() + b"\0")
        h.update(path.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=KERNELS) -> None:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together; raises if any build fails."""
    started = {name: _start(name) for name in names}
    errors = []
    for name, st in started.items():
        try:
            _finish(name, st)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
