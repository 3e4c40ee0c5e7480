"""The result line and the standard error's last lines, from whole runs of
the tiny checkout on the CPU."""
import json
import math

import pytest

import tiny
from harness.result import p95
from harness.spec import load_cell

CELLS = ["imagenet1k-report.eval", "cityscapes-seg.probs", "cityscapes-seg.labels"]
SEED = 2_147_483_659


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(root, capfd, cell, trace):
    import run

    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3", "--trace", str(trace)],
                  device_kind="cpu", root=root)
    out, err = capfd.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and isinstance(line["attempted"], int) and line["failed"] == 0
    spec = load_cell(root, cell)
    if trace:
        allowed = {m["name"]: m["unit"] for m in spec.per_layer}
        assert set(line["metrics"]) <= set(allowed) and "host_ms_per_step" in line["metrics"]
    else:
        allowed = {m["name"]: m["unit"] for m in spec.end_to_end}
        assert set(line["metrics"]) == set(allowed)
    for name, m in line["metrics"].items():
        assert m["unit"] == allowed[name] and math.isfinite(m["value"])
    assert line["device"]["count"] == spec.chips == 1
    assert set(line["checks"]) == {"state_cells_off", "value_err"}
    assert any(s.startswith("set-up s: python ") for s in err.splitlines())
    last = err.rstrip().splitlines()[-2:]
    assert [s.split(":")[0] for s in last] == ["check state_cells_off", "check value_err"]
    assert all("(limit " in s for s in last)


def test_no_card_means_no_result(root, capfd):
    import run
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "imagenet1k-report.eval", "--seed", "1", "--seconds", "1"], root=root)
    out, _ = capfd.readouterr()
    assert rc != 0 and out.strip() == ""


def test_p95_is_the_nearest_rank():
    assert p95(list(range(1, 101))) == 95
    assert p95([3.0]) == 3.0
    assert p95(list(range(1, 21))) == 19
