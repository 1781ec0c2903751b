"""Print the registers, spills and shared memory of each CUDA kernel the
port builds, as ``ptxas`` reports them.

Compiles each named kernel's source with the build's own flags
(``repro_torch.kernels._build.NVCC_FLAGS``) plus ``-Xptxas -v`` into a
scratch object under ``build/`` and prints one line per kernel
instantiation: its demangled name, registers a thread, spill stores and
loads (bytes), and static shared memory. Dynamic shared memory, which the
tensor-core kernels take, is set at launch and not in this report.

Usage, on a machine with ``nvcc``::

    python tools/kernel_resources.py                       # every kernel
    python tools/kernel_resources.py flash_attention flash_attention_bwd
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.kernels import _build  # noqa: E402

_FUNC = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def demangle(names: list[str]) -> list[str]:
    """C++ names through ``c++filt`` where it exists, else as given."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return names
    return out.stdout.splitlines()


def report(name: str) -> list[dict]:
    """One dict per kernel entry of ``name``'s source: ``kernel``,
    ``registers``, ``spill_stores``, ``spill_loads``, ``smem``."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    os.makedirs(_build.build_dir(), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        cmd = [_build._nvcc(), *flags, "-c", "-Xptxas", "-v", "-o",
               os.path.join(tmp, f"{name}.o"),
               str(_build.source_path(name))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    rows: list[dict] = []
    for line in log.splitlines():
        m = _FUNC.search(line)
        if m:
            rows.append({"kernel": m.group(1), "registers": None,
                         "spill_stores": 0, "spill_loads": 0, "smem": 0})
            continue
        if not rows:
            continue
        if (m := _USED.search(line)):
            rows[-1]["registers"] = int(m.group(1))
            if (s := _SMEM.search(line)):
                rows[-1]["smem"] = int(s.group(1))
        if (m := _SPILL.search(line)):
            rows[-1]["spill_stores"] = int(m.group(1))
            rows[-1]["spill_loads"] = int(m.group(2))
    for row, pretty in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = pretty.replace("(anonymous namespace)::", "")
    return rows


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or _build.KERNELS
    for name in names:
        for row in report(name):
            print(f"{name}: {row['kernel']}: {row['registers']} registers, "
                  f"spill stores {row['spill_stores']} B, spill loads "
                  f"{row['spill_loads']} B, static smem {row['smem']} B",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
