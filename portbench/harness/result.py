"""The result line: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), the device, and the check's numbers
beside their limits, from the result of one seed."""
import math
from typing import Dict, List

import torch


def p95(values: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


END_TO_END = {
    # every sample folded in the window, over its wall time
    "samples_per_s": lambda r, start_wall: r["samples"] / r["wall_s"],
    # the pass-end reads: compute() to every value on the host
    "compute_ms_p95": lambda r, start_wall: p95(r["compute_s"]) * 1e3,
    # process start to the first timed step
    "setup_s": lambda r, start_wall: r["t0_wall"] - start_wall,
}


def assemble(cell, r: dict, trace: bool, start_wall: float, device_kind: str) -> Dict:
    if trace:
        metrics = {m["name"]: {"value": r["layer"][m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in r.get("layer", {})}
    else:
        metrics = {m["name"]: {"value": END_TO_END[m["name"]](r, start_wall), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu" if device_kind == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if device_kind == "cuda" else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": r["memory_peak_bytes"]}
    line = {"correct": r["correct"], "attempted": r["reads"], "failed": r["failed"], "metrics": metrics,
            "device": device}
    if trace:
        if "busy_s" in r:
            device["busy_s"] = r["busy_s"]
            device["window_s"] = r["window_s"]
        if "breakdown" in r:
            line["breakdown"] = r["breakdown"]
    line["checks"] = r["checks"]
    return line
