"""The comm layer's mesh-free pieces and the dry-run's model cells against
the reference.

``plan_signature``/``group_signature``, ``configs.shapes``, the topology
half of ``launch.mesh``, the ``--comm`` dry-run and ``launch.report``:
each runs on both packages with the same inputs and must give EQUAL
results — signatures, skip reasons, launch specs and topology digests,
dry-run rows key for key (floats included), and rendered markdown.

The model cells: ``body_probes`` and ``_merge_by_op`` equal the
reference's; the cost count (``launch.cost``) of a reduced Llama's
forward is its products' FLOPs exactly; the L=0/L=1 extrapolation equals
the full-depth count for every reduced arch and step kind; ``run_cell``
on reduced configs keeps the reference's keys and agrees with its rows
where a count of the port's program can (identity, model FLOPs,
argument bytes, FLOPs within 0.5× to 2×).

Importing the reference's ``launch.dryrun`` sets ``XLA_FLAGS`` for 512
placeholder devices (its first lines); the fixture restores the variable,
so later subprocesses of the worker keep the test harness's setting.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.comm import PathPlanner as JPathPlanner
from repro.comm import TransferRequest as JRequest
from repro.comm.engine import group_signature as jgroup_signature
from repro.comm.engine import plan_signature as jplan_signature
from repro.configs import load_all as jload_all
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import cells as jcells
from repro.core import Topology as JTopology
from repro.launch import mesh as jmesh
from repro.launch import report as jreport

from repro_torch.comm import (PathPlanner, TransferRequest, group_signature,
                              plan_signature)
from repro_torch.configs import load_all
from repro_torch.configs import shapes
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.topology import Topology
from repro_torch.launch import dryrun, mesh, report

ROOT = pathlib.Path(__file__).resolve().parents[1]
MiB = 1 << 20


@pytest.fixture
def jdryrun(monkeypatch):
    if "XLA_FLAGS" in os.environ:
        monkeypatch.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
    else:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    from repro.launch import dryrun as jd
    return jd


# -- signatures ---------------------------------------------------------------

TOPOLOGIES = {"full_mesh4": (lambda cls: cls.full_mesh(4)),
              "torus4x4": (lambda cls: cls.torus2d(4, 4))}


@pytest.mark.parametrize("max_paths,num_chunks", [(1, 1), (3, 4), (2, 2)])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_plan_signature_equals_reference(topo, max_paths, num_chunks):
    make = TOPOLOGIES[topo]
    jp = JPathPlanner(make(JTopology), multipath_threshold=64)
    pp = PathPlanner(make(Topology), multipath_threshold=64)
    for src, dst in ((0, 1), (0, 3), (2, 1)):
        kw = dict(max_paths=max_paths, num_chunks=num_chunks,
                  granularity=4)
        want = jplan_signature(jp.plan(src, dst, 8 * MiB + 4096, **kw))
        got = plan_signature(pp.plan(src, dst, 8 * MiB + 4096, **kw))
        assert got == want
        assert len(got) <= max_paths and got[0][1] >= 1
    # stable: the same request twice gives the same signature
    assert plan_signature(pp.plan(0, 1, MiB)) == \
        plan_signature(pp.plan(0, 1, MiB))


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_group_signature_equals_reference(topo):
    make = TOPOLOGIES[topo]
    jp = JPathPlanner(make(JTopology), multipath_threshold=64)
    pp = PathPlanner(make(Topology), multipath_threshold=64)
    msgs = [(0, 1, 4 * MiB), (1, 2, 3 * MiB + 512), (3, 0, 64 * 1024)]
    want = jgroup_signature(jp.plan_group(
        [JRequest(s, d, n, granularity=4) for s, d, n in msgs]))
    got = group_signature(pp.plan_group(
        [TransferRequest(s, d, n, granularity=4) for s, d, n in msgs]))
    assert got == want
    assert [g[:3] for g in got] == msgs


# -- shapes -------------------------------------------------------------------

def test_shapes_equal_reference():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in shapes.SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind)
         for k, s in JSHAPES.items()}


def test_cells_skip_reasons_equal_reference():
    jarchs = [jload_all()[k] for k in sorted(jload_all())]
    archs = [load_all()[k] for k in sorted(load_all())]
    want = [(a.name, s.name, r) for a, s, r in jcells(jarchs)]
    got = [(a.name, s.name, r) for a, s, r in shapes.cells(archs)]
    assert got == want
    assert len(got) == 4 * len(archs)
    assert any(r is None for *_, r in got) and any(r for *_, r in got)


# -- launch.mesh --------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_and_topology_equal_reference(multi_pod):
    assert mesh.production_mesh_shape(multi_pod=multi_pod) == \
        jmesh.production_mesh_shape(multi_pod=multi_pod)
    got = mesh.make_production_topology(multi_pod=multi_pod)
    want = jmesh.make_production_topology(multi_pod=multi_pod)
    assert (got.name, got.num_devices, got.num_islands) == \
        (want.name, want.num_devices, want.num_islands)
    assert got.digest() == want.digest()
    assert (mesh.DCN_EGRESS_PER_POD, mesh.DCN_LINK_GBPS) == \
        (jmesh.DCN_EGRESS_PER_POD, jmesh.DCN_LINK_GBPS)


def test_multi_pod_launch_specs_resolve_island_aware_meshes():
    """The reference's acceptance (``tests/test_hierarchy.py``): the
    kimi/nemotron specs resolve 2-pod meshes and hierarchical topologies;
    smaller archs stay on the flat pod."""
    from repro_torch.configs import get_config

    load_all()
    for arch_name in ("kimi_k2_1t_a32b", "nemotron_4_340b"):
        spec = mesh.production_launch_spec(get_config(arch_name))
        assert spec["multi_pod"], arch_name
        assert spec["mesh_shape"] == (2, 16, 16)
        assert spec["mesh_axes"] == ("pod", "data", "model")
        assert spec["topology"].num_islands == 2
        assert spec["topology"].num_devices == 512
    spec = mesh.production_launch_spec(get_config("llama3_8b"))
    assert not spec["multi_pod"]
    assert spec["mesh_shape"] == (16, 16)
    assert spec["topology"].num_islands == 1


def test_launch_specs_equal_reference_for_every_arch():
    jarchs, archs = jload_all(), load_all()
    assert sorted(jarchs) == sorted(archs)
    for name in sorted(archs):
        got = mesh.production_launch_spec(archs[name])
        want = jmesh.production_launch_spec(jarchs[name])
        assert got.keys() == want.keys()
        for key in ("arch", "multi_pod", "mesh_shape", "mesh_axes"):
            assert got[key] == want[key], (name, key)
        assert got["topology"].digest() == want["topology"].digest()


# -- the --comm dry-run and the report -----------------------------------------

@pytest.mark.parametrize("fail_link", [None, (0, 1)])
def test_comm_dryrun_rows_equal_reference(jdryrun, tmp_path, fail_link,
                                          capsys):
    want = jdryrun.run_comm_dryrun(str(tmp_path / "ref.json"),
                                   fail_link=fail_link)
    ref_out = capsys.readouterr().out
    got = dryrun.run_comm_dryrun(str(tmp_path / "port.json"),
                                 fail_link=fail_link)
    assert capsys.readouterr().out == ref_out
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g == w
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())
    kinds = {r["kind"] for r in got}
    assert kinds == ({"comm_graph", "comm_schedule"} if fail_link is None
                     else {"comm_graph", "comm_schedule", "comm_fault"})


def test_comm_dryrun_keeps_other_rows_and_replaces_stale_comm_rows(tmp_path):
    out = tmp_path / "rows.json"
    other = {"kind": "model", "status": "skipped", "arch": "a",
             "shape": "s", "mesh": "m", "reason": "r"}
    out.write_text(json.dumps([other, {"kind": "comm_graph", "stale": 1}]))
    rows = dryrun.run_comm_dryrun(str(out))
    saved = json.loads(out.read_text())
    assert saved[0] == other and saved[1:] == json.loads(json.dumps(rows))


def test_comm_dryrun_skips_topologies_without_the_link(jdryrun, tmp_path,
                                                      capsys):
    """A link absent from a topology skips its fault row. The reference
    means to (it catches a ``KeyError`` from ``Topology.link``), but
    ``link`` returns None there, and ``fail_link`` raises."""
    with pytest.raises(KeyError):
        jdryrun.run_comm_dryrun(str(tmp_path / "ref.json"), fail_link=(0, 4))
    capsys.readouterr()
    rows = dryrun.run_comm_dryrun(str(tmp_path / "r.json"),
                                  fail_link=(0, 4))
    assert "no link 0->4, skipped" in capsys.readouterr().out
    faults = [r for r in rows if r["kind"] == "comm_fault"]
    assert [r["topology"] for r in faults] == ["torus4x4", "hier2x4"]


@pytest.mark.parametrize("fail_link", [None, (0, 1)])
def test_report_renders_like_reference(tmp_path, fail_link, capsys,
                                      monkeypatch):
    rows = dryrun.run_comm_dryrun(str(tmp_path / "rows.json"),
                                  fail_link=fail_link)
    capsys.readouterr()
    for fmt in ("fmt_comm_table", "fmt_schedule_table", "fmt_fault_table"):
        kind = {"fmt_comm_table": "comm_graph",
                "fmt_schedule_table": "comm_schedule",
                "fmt_fault_table": "comm_fault"}[fmt]
        sub = [r for r in rows if r["kind"] == kind]
        assert getattr(report, fmt)(sub) == getattr(jreport, fmt)(sub)
    model_rows = [
        {"arch": "b", "shape": "s", "status": "skipped", "reason": "why",
         "mesh": "single_pod_16x16"},
        {"arch": "a", "shape": "s", "status": "ok", "kind": "train",
         "mesh": "single_pod_16x16", "memory_per_device_gb": 1.5,
         "compute_s": 0.1, "memory_s": 0.2, "collective_s": 0.3,
         "bottleneck": "memory", "model_flops": 1e12,
         "useful_flops_ratio": 0.5,
         "collective_by_op": {"all-reduce": {"wire_bytes": 3e9}}}]
    assert report.fmt_table(model_rows, "m") == \
        jreport.fmt_table(model_rows, "m")
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(model_rows + rows))
    rendered = []
    for mod in (report, jreport):
        monkeypatch.setattr(sys, "argv", ["report", str(path)])
        mod.main()
        rendered.append(capsys.readouterr().out)
    assert rendered[0] == rendered[1]
    assert ("Link-fault re-plans" in rendered[0]) == (fail_link is not None)


def test_clis_run_as_modules(tmp_path):
    """``python -m repro_torch.launch.dryrun --comm --fail-link 0:1``, the
    model-cell sweep of one arch and shape, and ``python -m
    repro_torch.launch.report`` over both exit 0; the report renders the
    model rows beside the comm rows; bad arguments are usage errors."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = tmp_path / "rows.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--comm",
         "--fail-link", "0:1", "--out", str(out)], capture_output=True,
        text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "comm dry-run complete: 68 rows" in run.stdout
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", str(out)],
        capture_output=True, text=True, env=env, timeout=120)
    assert rep.returncode == 0, rep.stderr
    assert rep.stdout.startswith("Cells: 0 compiled, 0 skipped, 0 errors; "
                                 "24 transfer graphs; 40 schedule cells; "
                                 "4 fault cells.")
    # the model cells: one arch and shape on both production meshes, into
    # the same JSON, then the report renders them beside the comm rows
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-360m", "--shape", "decode_32k", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "dry-run complete: ok=2 skipped=0 error=0" in run.stdout
    rows = json.loads(out.read_text())
    cells = [r for r in rows if r.get("arch") == "smollm_360m"]
    assert [r["mesh"] for r in cells] == ["single_pod_16x16",
                                          "multi_pod_2x16x16"]
    assert all(r["status"] == "ok" and r["chips"] in (256, 512)
               and r["note"] == dryrun.NOTE for r in cells)
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", str(out)],
        capture_output=True, text=True, env=env, timeout=120)
    assert rep.returncode == 0, rep.stderr
    assert rep.stdout.startswith("Cells: 2 compiled, 0 skipped, 0 errors; "
                                 "24 transfer graphs;")
    assert "| smollm_360m | decode_32k | decode |" in rep.stdout
    assert "### Mesh `multi_pod_2x16x16`" in rep.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--fail-link",
         "0:1"], capture_output=True, text=True, env=env, timeout=120)
    assert bad.returncode == 2 and "--comm" in bad.stderr
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--comm",
         "--fail-link", "0-1"], capture_output=True, text=True, env=env,
        timeout=120)
    assert bad.returncode == 2 and "SRC:DST" in bad.stderr


# -- the model cells: specs, cost counts, probes, rows ----------------------

REDUCED = sorted(jload_all())
KINDS = {"train": ShapeConfig("train", 128, 8, "train"),
         "prefill": ShapeConfig("prefill", 128, 8, "prefill"),
         "decode": ShapeConfig("decode", 128, 8, "decode")}
#: Bytes the L=0/L=1 extrapolation adds a layer past the first: 0-d terms
#: that a non-empty layer stack brings once a step, which the L=1 probe's
#: increment carries into every layer. Mixtral: the aux loss's scale in
#: the backward (a float32 read and write); Kimi K2 also its int8 moments'
#: absmax scales (the empty stack of the L=0 probe takes the codec's
#: empty-leaf branch).
ONCE_A_STEP = {("mixtral_8x22b", "train"): 8,
               ("kimi_k2_1t_a32b", "train"): 528}


def small_mesh():
    return mesh.LogicalMesh(("data", "model"), (2, 4))


@pytest.mark.parametrize("name", REDUCED)
def test_body_probes_equal_the_reference(jdryrun, name):
    from repro_torch.configs import get_config

    got = dryrun.body_probes(get_config(name))
    want = jdryrun.body_probes(jload_all()[name])
    assert [(n, dataclasses.asdict(c)) for n, c in got] == \
        [(n, dataclasses.asdict(c)) for n, c in want]
    assert sum(n for n, _ in got) == get_config(name).num_layers


def test_merge_by_op_equals_the_reference(jdryrun):
    base = {"all-reduce": {"count": 2, "wire_bytes": 10.0}}
    body = {"all-reduce": {"count": 1, "wire_bytes": 3.0},
            "all-gather": {"count": 4, "wire_bytes": 1.5}}
    assert dryrun._merge_by_op(base, body, 7) == \
        jdryrun._merge_by_op(base, body, 7)
    assert base == {"all-reduce": {"count": 2, "wire_bytes": 10.0}}


def test_forward_flops_of_a_reduced_llama_are_its_products():
    """The prefill cell's FLOPs on meta are the products' ``2·m·n·k``
    (projections, the MLP, RMSNorm's row sums, the head) plus the
    attention kernel's ``4·D`` a pair its causal mask keeps, exactly."""
    from repro_torch.configs import get_config
    from repro_torch.launch import cost

    cfg = get_config("llama3_8b").reduced()
    b, s = 8, 128
    _, (_, counted) = dryrun.lower_and_compile(cfg, KINDS["prefill"],
                                               small_mesh())
    t, d, h, kv, hd = b * s, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim_
    layer = (2 * t * d * h * hd + 2 * 2 * t * d * kv * hd
             + 2 * t * h * hd * d + 3 * 2 * t * d * cfg.d_ff
             + 4 * b * h * hd * s * (s + 1) // 2 + 2 * 2 * t * d)
    want = (cfg.num_layers * layer + 2 * t * d
            + 2 * t * d * cfg.vocab_size)
    assert counted.flops == want
    assert counted.kernels == {"flash_attention": cfg.num_layers}
    assert cost.attention_flops(b, h, s, hd, True, None) == \
        4 * b * h * hd * s * (s + 1) // 2


@pytest.mark.parametrize("name,kind", [
    (a, k) for a in REDUCED for k in sorted(KINDS)
    if k != "decode" or jload_all()[a].causal])      # an encoder: no decode
def test_extrapolated_cost_equals_the_full_depth_count(name, kind):
    """The L=0/L=1 probes extrapolate to the full-depth count of every
    reduced arch: FLOPs, collective records and their wire bytes exactly;
    HBM bytes exactly but for :data:`ONCE_A_STEP`."""
    from repro_torch.configs import get_config

    cfg = get_config(name).reduced()
    m = small_mesh()
    flops, hbm, wire, by_op = dryrun.extrapolated_cost(cfg, KINDS[kind], m)
    _, (_, full) = dryrun.lower_and_compile(cfg, KINDS[kind], m)
    f, b, w, ops = dryrun._cost_tuple(full)
    assert (flops, wire, by_op) == (f, w, ops)
    extra = ONCE_A_STEP.get((name, kind), 0)
    assert hbm - b == (cfg.num_layers - 1) * extra
    assert flops > 0 and b > 0 and full.peak_bytes > 0
    assert bool(wire) == bool(cfg.num_experts)


RUN_CELLS = [(a, k) for a in ("llama3_8b", "mixtral_8x22b", "rwkv6_1_6b")
             for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("name,kind", RUN_CELLS)
def test_run_cell_against_the_reference(jdryrun, name, kind):
    """``run_cell`` of a reduced config on a ``(2, 4)`` mesh (the port's
    with a CPU session, so an MoE layer's combine runs the ring on meta)
    against the reference's on the test harness's 8 CPU devices: the same
    keys; equal identity, kind, chips, description and model FLOPs;
    argument bytes to 1e-9 (the reference's compiled decode step of
    RWKV-6 drops its unused position, 4 bytes); FLOPs × chips within 0.5×
    to 2× of the compiler's count (which counts elementwise work too)."""
    from repro.compat import make_mesh
    from repro.configs.shapes import ShapeConfig as JShapeConfig
    from repro_torch.configs import get_config

    sh = KINDS[kind]
    want = jdryrun.run_cell(jload_all()[name].reduced(),
                            JShapeConfig(sh.name, sh.seq_len,
                                         sh.global_batch, sh.kind),
                            make_mesh((2, 4), ("data", "model")), "m")
    got = dryrun.run_cell(get_config(name).reduced(), sh,
                          mesh.make_host_mesh((2, 4), device="cpu"), "m")
    assert got.keys() == want.keys()
    for key in ("arch", "shape", "mesh", "status", "kind", "chips",
                "description", "model_flops"):
        assert got[key] == want[key], key
    unused = 4 / 2**30 if (name, kind) == ("rwkv6_1_6b", "decode") else 0
    assert got["argument_gb"] - unused == pytest.approx(want["argument_gb"],
                                                        rel=1e-9)
    ratio = got["flops"] * got["chips"] / (want["flops"] * want["chips"])
    print(f"{name} {kind}: FLOPs x chips {ratio:.3f} of the reference's")
    assert 0.5 <= ratio <= 2.0, ratio
    assert got["bottleneck"] in ("compute", "memory", "collective")
    assert got["memory_per_device_gb"] == pytest.approx(
        got["argument_gb"] + got["output_gb"] - got["alias_gb"]
        + got["temp_gb"], rel=1e-12)
    # the combine: one psum a MoE layer a forward (and one in the
    # backward), every device in one group of the model axis
    if name == "mixtral_8x22b":
        layers = jload_all()[name].reduced().num_layers
        calls = {"train": 2 * layers, "prefill": layers,
                 "decode": layers}[kind]
        assert got["collective_by_op"]["all-reduce"]["count"] == calls
    else:
        assert got["collective_by_op"] == {}


def test_a_sessionless_mesh_counts_its_collectives_on_meta_only():
    """The production mesh has no session: an MoE layer under it raises
    outside a count, and inside a count of meta tensors records its
    combine and runs nothing."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import cost
    from repro_torch.models import transformer as tfm

    cfg = get_config("mixtral_8x22b").reduced()
    params = tfm.param_shapes(cfg)
    lp = tfm.layer_params(params, 0)
    x = torch.empty((16, 4, cfg.d_model), device="meta")
    m = mesh.LogicalMesh(("data", "model"), (2, 4))
    with mesh.set_mesh(m):
        with pytest.raises(ValueError, match="no session"):
            tfm._ffn(x, lp, cfg)
        (out, _), c = cost.count(tfm._ffn, x, lp, cfg)
        with pytest.raises(ValueError, match="no session"):
            cost.count(tfm._ffn, torch.zeros((16, 4, cfg.d_model)),
                       tfm.layer_params(tfm.init_params(
                           cfg, generator=torch.Generator().manual_seed(0)),
                           0), cfg)
    assert out.shape == x.shape and out.device.type == "meta"
    row = 32 * cfg.d_model * 4
    assert c.collectives == [("all-reduce", row, 4)] * 2
