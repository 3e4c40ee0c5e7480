"""A tiny checkout for the harness's CPU tests: ``BENCHMARK.json`` and its
configurations and mixes cut to sizes a test run holds, with the same
cells, traffic names and collections as the real ones."""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
# the harness and the program, as run.py finds them
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

SIZES = {
    "imagenet1k-report": {"classes": 10, "samples_per_pass": 400, "distinct_samples": 400},
    "cityscapes-seg": {"classes": 5, "samples_per_pass": 12, "distinct_samples": 4, "sample_shape": [8, 16]},
}
BATCH = {"eval": 40, "probs": 1, "labels": 1}


def load(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def checkout(tmp: str) -> str:
    """Write the tiny checkout under ``tmp`` and return its root."""
    bench = load("BENCHMARK.json")
    for kind in ("configs", "mixes"):
        os.makedirs(os.path.join(tmp, "portbench", kind), exist_ok=True)
    for c in bench["configs"]:
        cfg = load(c["file"])
        cfg.update(SIZES[c["name"]])
        for m in cfg["collection"]["members"].values():
            if "num_classes" in m["args"]:
                m["args"]["num_classes"] = cfg["classes"]
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        mix = load(os.path.join("portbench", "mixes", w["traffic"] + ".json"))
        mix.update(batch=BATCH[w["traffic"]], trace_steps=4, trace_passes=2)
        with open(os.path.join(tmp, "portbench", "mixes", w["traffic"] + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
