"""The port's training example and launcher run end to end on the CPU.

``examples_torch/train_smollm.py`` at its default mini size (a few steps)
in each of its three modes prints a line per logged step with a finite
loss and the schedule's learning rate, and the captured run's accounting
says one dispatch a step. ``python -m repro_torch.launch.train --reduced
--device cpu`` trains, checkpoints and resumes from its checkpoint.
"""

import importlib.util
import math
import pathlib
import re

import pytest

from repro_torch.launch import train as launch_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_LINE = re.compile(r"^step +(\d+) +loss (\S+) +lr (\S+)$")


def load_example():
    spec = importlib.util.spec_from_file_location(
        "train_smollm_port", ROOT / "examples_torch" / "train_smollm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
