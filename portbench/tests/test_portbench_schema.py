"""``BENCHMARK.json`` against the benchmark's schema, and every file the
harness finds by a name in it."""
import json
import os
import re

import pytest

from tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$)")


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) and ".." not in p.split("/") for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in bench["command"])
    assert all(".." not in w.split("/") for w in bench["command"])
    named = [w for w in bench["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in bench["paths"]) for w in named)
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and c["source"].startswith("https://") and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "reference", cfg["reference"] + ".py"))
        assert float(cfg["limits"]["value_err"]) > 0


def test_workloads(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    four = [w for w in ws if w["chips"] == 4]
    assert len(four) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        with open(os.path.join(ROOT, bench["paths"][0], "mixes", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        assert mix["preds"] in ("probs", "labels") and int(mix["batch"]) > 0


def _reports(metric, cell):
    return cell in metric["workloads"] if "workloads" in metric else True


def test_metrics(bench):
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    for m in layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "layer_metrics", m["name"] + ".py"))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        moved = next(e for e in e2e if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(moved, cell), (m["name"], cell)
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        got = [m["name"] for m in e2e if _reports(m, cell)]
        assert "setup_s" in got and len(got) >= 2
        assert any(_reports(m, cell) for m in layer)


def test_layers_name_one_layer_each(bench):
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_time_fits_with_every_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        rs = json.load(f)["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
