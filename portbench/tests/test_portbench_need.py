"""What a step needs, from the configuration and the mix alone; the device
time a call launched, apart from the work queued before it; and a cell the
harness cannot run."""
import copy
import json
import os

import pytest

import tiny
from harness import roofline, tracing
from harness.spec import load_cell

# preds read once, int64 targets read once, and the confusion matrix's
# touched int64 entries read and written once
NEED = {
    ("imagenet1k-report", "eval"): 2000 * 1000 * 4 + 2000 * 8 + 2 * 2000 * 8,
    ("cityscapes-seg", "probs"): 2048 * 1024 * 19 * 4 + 2048 * 1024 * 8 + 2 * 19 * 19 * 8,
    ("cityscapes-seg", "labels"): 2048 * 1024 * 8 + 2048 * 1024 * 8 + 2 * 19 * 19 * 8,
}


@pytest.mark.parametrize("config,mix", sorted(NEED))
def test_step_need_from_the_shapes(config, mix):
    cfg = tiny.load(os.path.join("portbench", "configs", config + ".json"))
    mx = tiny.load(os.path.join("portbench", "mixes", mix + ".json"))
    need = roofline.step_need(cfg, mx)
    assert need["bytes"] == NEED[(config, mix)]
    assert need["flops"] == (0 if mx["preds"] == "labels" else int(mx["batch"]) * cfg["classes"]
                             * (2048 * 1024 if cfg["sample_shape"] else 1))


def test_launched_work_is_the_calls_own():
    # a read from t=100 to t=200 launches two operations of 5 us; an update
    # launched at t=90 runs 40 us inside the read's span and is not the read's
    launched = [(90.0, 40.0), (120.0, 5.0), (150.0, 5.0), (250.0, 7.0)]
    assert tracing.launched_within_us(launched, [(100.0, 200.0)]) == 10.0
    assert tracing.launched_within_us(launched, [(100.0, 200.0), (240.0, 260.0)]) == 17.0
    assert tracing.launched_within_us(launched, []) == 0.0


def test_a_cell_over_several_chips_is_refused(tmp_path):
    root = tiny.checkout(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    four = copy.deepcopy(bench["workloads"][0])
    four.update(name="imagenet1k-report.four", chips=4)
    bench["workloads"].append(four)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    assert load_cell(root, bench["workloads"][0]["name"]).chips == 1
    with pytest.raises(SystemExit, match="one rank on one card"):
        load_cell(root, "imagenet1k-report.four")
