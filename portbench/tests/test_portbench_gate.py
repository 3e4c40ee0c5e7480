"""The check that decides ``correct``, driven through the rest of a run at
tiny sizes on the CPU: sound runs pass, the control and each planted fault
fail."""
import json

import pytest
import torch

import faults
import tiny
from harness.cell import run_seeds
from harness.spec import load_cell

ONE_RANK = ["imagenet1k-report.eval", "cityscapes-seg.probs", "cityscapes-seg.labels"]
SEED = 3_000_000_019  # above 32 signed bits: a seed may be any whole number


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(str(tmp_path_factory.mktemp("tiny")))


def _line(capsys, root, cell, trace=0):
    import run

    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3", "--trace", str(trace)],
                  device_kind="cpu", root=root)
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", ONE_RANK)
def test_sound_run_is_correct(root, capsys, cell):
    line, _ = _line(capsys, root, cell)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 1
    assert line["checks"]["state_cells_off"]["value"] == 0


@pytest.mark.parametrize("cell", ONE_RANK)
def test_control_is_not_correct(root, cell):
    r = run_seeds(load_cell(root, cell), torch.device("cpu"), [SEED], 0.2, False, control=True)[0]
    c = r["control_checks"]
    assert c["state_cells_off"]["value"] > 0 or c["value_err"]["value"] > c["value_err"]["limit"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ONE_RANK)
def test_planted_fault_is_not_correct(root, capsys, monkeypatch, cell, fault):
    from metrics_tpu_torch.core.collections import MetricCollection

    for name in ("update", "compute"):
        monkeypatch.setattr(MetricCollection, name, getattr(MetricCollection, name))
    faults.plant(fault)
    line, err = _line(capsys, root, cell)
    assert not line["correct"] and line["failed"] > 0
    assert err.rstrip().splitlines()[-1].startswith("check value_err:")



@pytest.mark.parametrize("cell", ONE_RANK)
def test_calibration_reads_the_control_above_the_program(root, capsys, cell):
    import calibrate

    assert calibrate.main(["--workload", cell, "--seeds", f"{SEED},{SEED + 1}", "--seconds", "0.2"],
                          device_kind="cpu", root=root) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [r["seed"] for r in lines[:-1]] == [SEED, SEED + 1] and all(r["correct"] for r in lines[:-1])
    lower, upper = lines[-1]["lower"], lines[-1]["upper"]
    assert lower["state_cells_off"] == 0
    assert upper["value_err"] > lower["value_err"]
