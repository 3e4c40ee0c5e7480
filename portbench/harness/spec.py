"""A cell as ``BENCHMARK.json`` names it: the entry, its configuration file
and its traffic mix, all read as data.

A configuration lives in the file its ``configs`` entry names; a traffic
mix in ``<paths[0]>/mixes/<traffic>.json``; a per-layer metric's reader in
``layer_metrics/<name>.py`` and a reference in ``reference/<name>.py``
beside this package. Adding a cell, a configuration or a metric adds files
and entries; nothing here names one.
"""
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List

HARNESS_DIR = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HARNESS_DIR)


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    chips: int = 1
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its configuration
    and mix, and the metrics it reports (an end-to-end metric with a
    ``workloads`` key only in those cells; a per-layer metric where it lists
    the cell, or in every cell that reports the metric it moves)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[entry["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, bench["paths"][0], "mixes", entry["traffic"] + ".json")) as f:
        mix = json.load(f)
    if int(entry["chips"]) != 1:
        raise SystemExit(f"{name}: the harness runs one rank on one card; it has no launcher for {entry['chips']} chips")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in e2e_names]
    return Cell(name, config, mix, int(entry["chips"]), e2e, per_layer)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` beside the harness (``layer_metrics``,
    ``reference``), imported by its path: such names hold ``-`` and ``.``."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
