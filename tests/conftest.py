"""Test harness config.

Multipath-transfer and collective tests need a handful of devices; we give
the CPU platform 8 (NOT 512 — the production-mesh dry-run manages its own
device count in its own process, per the launcher contract).
"""

import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

import pytest  # noqa: E402

from repro.compat import make_mesh  # noqa: E402
from repro.core import HOST, Link, Topology  # noqa: E402


@pytest.fixture(scope="session")
def dev_mesh():
    """1-D 8-device mesh used by transfer-engine tests."""
    return jax.sharding.Mesh(jax.devices(), ("dev",))


@pytest.fixture(scope="session")
def dp_tp_mesh():
    """2-D (data=2, model=4) mesh used by model-sharding tests."""
    return make_mesh((2, 4), ("data", "model"))


# -- shared topology fixture library ----------------------------------------
# Topologies are mutable (add/remove_link, calibration, node assignment),
# so fixtures default to function scope: each test gets a fresh instance.
# ``mesh8`` is module-scoped because module-scoped planner/session
# fixtures depend on it — tests that mutate a topology build their own.

@pytest.fixture
def beluga4():
    """The paper's Beluga node: 4-GPU NVLink full mesh + PCIe host path."""
    return Topology.full_mesh(4)


@pytest.fixture
def mesh4():
    """4-GPU NVLink full mesh without a host path."""
    return Topology.full_mesh(4, with_host=False, name="mesh4")


@pytest.fixture(scope="module")
def mesh8():
    """8-GPU NVLink full mesh without a host path (engine-sized)."""
    return Topology.full_mesh(8, with_host=False, name="mesh8")


@pytest.fixture
def torus4x4():
    """TPU-style 4×4 ICI torus (16 chips)."""
    return Topology.torus2d(4, 4)


def make_bridge_topology() -> Topology:
    """3 GPUs + host where the only alternative 0→1 path stages mid-route
    through the host: 0↔1 (direct), 0↔2, 2↔HOST, HOST↔1. The detour
    (0,2),(2,HOST),(HOST,1) records via=2, so a via-only executability
    check misses the host hop."""
    gb = 25.0
    links = []
    for a, b in ((0, 1), (0, 2)):
        links += [Link(a, b, "nvlink", gb), Link(b, a, "nvlink", gb)]
    links += [Link(2, HOST, "pcie", 12.0), Link(HOST, 2, "pcie", 12.0),
              Link(HOST, 1, "pcie", 12.0), Link(1, HOST, "pcie", 12.0)]
    return Topology(3, links, name="bridge3")


@pytest.fixture
def bridge3():
    """Host-bridged 3-GPU topology (see :func:`make_bridge_topology`)."""
    return make_bridge_topology()


@pytest.fixture
def two_island():
    """Hierarchical 2-island × 4-GPU topology (NVLink islands + one
    inter-node link pair per island pair)."""
    return Topology.hierarchical(2, 4, name="two_island")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one "
        "(on the card: python -m pytest -q --noconftest tests/test_torch_cuda.py)")
