"""The port's examples and its training launcher run end to end on the CPU.

``examples_torch/train_smollm.py`` at its default mini size (a few steps)
in each of its three modes prints a line per logged step with a finite
loss and the schedule's learning rate, and the captured run's accounting
says one dispatch a step. ``python -m repro_torch.launch.train --reduced
--device cpu`` trains, checkpoints and resumes from its checkpoint, for
the dense, RWKV-6, hybrid and MoE families.

``quickstart.py``, ``jacobi_multipath.py`` and ``serve_batched.py`` run
beside the reference's scripts of the same names (``examples/``, run in
this process on the 8 CPU devices the test harness gives JAX), on the
same inputs where the scripts share them: every line the two print is
equal but for times (the plans, chunk tasks, modeled bandwidths, the
tuner's choice, dispatches and plan-cache counts), Jacobi's max|u| after
the iterations is equal to its 4 printed decimals, its captured graph's
node counts, schedule and one dispatch a step equal, and serving's
request lines (prompt lengths and new-token counts; the tokens differ,
since the weights are drawn by each package's own generator) and its
migration's cache counts equal.
"""

import importlib.util
import math
import pathlib
import re
import sys

import pytest

from repro_torch.launch import train as launch_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_LINE = re.compile(r"^step +(\d+) +loss (\S+) +lr (\S+)$")


def load_example(name="train_smollm", folder="examples_torch"):
    spec = importlib.util.spec_from_file_location(
        f"{name}_{folder}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both_outputs(name, capsys, monkeypatch, port_args, ref_args=()):
    """Run the reference's example ``name`` (its argv ``ref_args``) and
    the port's (``port_args`` and ``--device cpu``); their printed
    lines."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *ref_args])
    load_example(name, "examples").main()
    ref = capsys.readouterr().out.splitlines()
    load_example(name).main(["--device", "cpu", *port_args])
    return ref, capsys.readouterr().out.splitlines()


TIMES = re.compile(r"\d+ iters in [0-9.]+s \([0-9.]+ ms/iter\)|"
                   r"\d+ tokens in [0-9.]+s \([0-9.]+ tok/s")


def test_quickstart_prints_the_reference_lines(capsys, monkeypatch):
    ref, got = both_outputs("quickstart", capsys, monkeypatch, [])
    assert got[0].startswith("plan: 3 paths, 40 copy nodes")
    describe = [l for l in got if l.startswith("describe: ")]
    assert describe and describe[0].startswith("describe: 40 copy nodes")
    got = [l for l in got if not l.startswith("describe: ")]
    assert len(got) == len(ref) == 10
    for a, b in zip(got[:-1], ref[:-1]):      # the last line: timings
        assert a == b
    assert "fused 2-message exchange OK; dispatches=3" in got
    assert got[-1].startswith("lifecycle: ") and got[-1].endswith(
        "(2 launches)")


def test_jacobi_example_matches_the_reference(capsys, monkeypatch):
    args = ["--iters", "5", "--cols-per-rank", "64", "--captured"]
    ref, got = both_outputs("jacobi_multipath", capsys, monkeypatch, args,
                            args)
    assert len(got) == 5 and len(ref) == 5
    for a, b in zip(got[:4], ref[:4]):
        assert TIMES.sub("", a) == TIMES.sub("", b)
    assert got[3] == ("  one heterogeneous graph: 16 copy + 2 compute "
                      "nodes, schedule=round_robin; 5 dispatches for 5 "
                      "iterations (exactly one per step)")
    assert got[4].startswith(ref[4][:40])


def test_serve_example_matches_the_reference(capsys, monkeypatch):
    ref, got = both_outputs("serve_batched", capsys, monkeypatch, [])
    assert len(got) == len(ref) == 6
    for a, b in zip(got[:4], ref[:4]):
        assert a.split(" tokens:")[0] == b.split(" tokens:")[0]
    assert TIMES.sub("", got[4]) == TIMES.sub("", ref[4])
    assert got[5] == ref[5] == ("KV migration OK=True; comm cache: "
                                "{'hits': 1, 'misses': 1, 'evictions': 0, "
                                "'size': 1, 'capacity': 64}")


@pytest.mark.parametrize("mode", [[], ["--manual-collectives"],
                                  ["--captured-step"]])
def test_train_smollm_example(tmp_path, capsys, mode):
    steps = 4
    load_example().main(["--device", "cpu", "--steps", str(steps),
                         "--ckpt-dir", str(tmp_path)] + mode)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("training smollm_mini: ")
    lines = [STEP_LINE.match(l) for l in out if STEP_LINE.match(l)]
    assert [int(m.group(1)) for m in lines] == list(range(steps))
    assert all(math.isfinite(float(m.group(2))) for m in lines)
    assert float(lines[0].group(3)) > 0
    assert (tmp_path / f"step_{steps:08d}" / "index.json").exists()
    if mode == ["--captured-step"]:
        assert any("as ONE graph" in l for l in out)
        acct = [l for l in out if l.startswith("captured-step accounting")]
        assert acct and acct[0].startswith(
            f"captured-step accounting: {steps} dispatches for {steps} "
            f"steps")


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "hymba_1_5b",
                                  "mixtral_8x22b"])
def test_launch_train_runs_every_family(tmp_path, capsys, arch):
    """``python -m repro_torch.launch.train --arch <family> --reduced
    --device cpu`` trains the RWKV-6, hybrid and MoE families: a line per
    logged step with a finite loss, then the summary."""
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "3", "--seq", "16", "--batch", "4",
                       "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    steps = [l.split() for l in out if l.startswith("step ")]
    assert [int(l[1]) for l in steps] == [0, 1, 2]
    assert all(math.isfinite(float(l[3])) for l in steps)
    assert out[-1].startswith("done: 3 steps")


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--reduced", "--device", "cpu", "--steps", "6", "--seq", "16",
            "--batch", "4", "--log-every", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3"]
    launch_train.main(args)
    first = capsys.readouterr().out
    assert "done: 6 steps" in first
    args[args.index("--steps") + 1] = "8"
    launch_train.main(args)
    second = capsys.readouterr().out.splitlines()
    assert second[0] == "restored checkpoint at step 6"
    assert second[-1].startswith("done: 2 steps")
    assert any(l.startswith("step     7 loss") for l in second)
