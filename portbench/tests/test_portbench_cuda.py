"""The harness on the card, at the tiny checkout's sizes: sound runs pass
the check, the control fails it, and a traced run reads every per-layer
metric of its cell from the profiler. Run on a machine with a card:

    python -m pytest --noconftest -m cuda portbench/tests
"""
import json

import pytest
import torch

import tiny
from harness.cell import run_seeds
from harness.spec import load_cell

ONE_RANK = ["imagenet1k-report.eval", "cityscapes-seg.probs", "cityscapes-seg.labels"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return tiny.checkout(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_RANK)
def test_sound_run_and_control_on_the_card(root, cell):
    r = run_seeds(load_cell(root, cell), torch.device("cuda", 0), [91, 92], 0.5, False, control=True)
    for one in r:
        assert one["correct"], one["checks"]
        c = one["control_checks"]
        assert c["state_cells_off"]["value"] > 0 or c["value_err"]["value"] > c["value_err"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_RANK)
def test_traced_line_on_the_card(root, capfd, cell):
    import run

    assert run.main(["--workload", cell, "--seed", "93", "--seconds", "0.5", "--trace", "1"], root=root) == 0
    line = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    spec = load_cell(root, cell)
    want = {m["name"] for m in spec.per_layer}
    assert want <= set(line["metrics"]), want - set(line["metrics"])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]
    for name in ("update_roofline", "mfu_pct", "idle_pct"):
        assert 0 <= line["metrics"][name]["value"] <= 100
