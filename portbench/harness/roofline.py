"""What one update step needs, from the configuration and the mix alone, and
the card's peaks.

Every configuration here folds its samples into one confusion matrix: each
metric of the collection is a function of it. So a step, whatever the
program keeps, needs its inputs read once (the preds as the mix sends them,
the int64 targets) and the matrix's entries it touches read and written
once, as int64 counts: one entry a sample at most, and no more than the
matrix holds. Finding a sample's class takes one comparison a score; preds
that are labels already need none. The peaks are NVIDIA's data sheet
(``peaks.json``), keyed by ``torch.cuda.get_device_name()``: a card not in
the table gets no share.
"""
import json
import math
import os
from typing import Optional

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")
_BYTES = {"float32": 4, "float16": 2, "bfloat16": 2, "float64": 8}
_COUNT_BYTES = 8  # an int64 label, target or count


def step_need(config: dict, mix: dict) -> dict:
    classes = int(config["classes"])
    samples = int(mix["batch"]) * math.prod(config["sample_shape"])
    if mix["preds"] == "probs":
        scores = samples * classes
        preds_bytes = scores * _BYTES[config["preds_dtype"]]
    else:
        scores, preds_bytes = 0, samples * _COUNT_BYTES
    touched = min(samples, classes * classes)
    return {"bytes": preds_bytes + samples * _COUNT_BYTES + 2 * touched * _COUNT_BYTES, "flops": scores}


def peak(device_name: str) -> Optional[dict]:
    with open(_PEAKS) as f:
        return json.load(f).get(device_name)


def least_seconds(need: dict, pk: dict) -> float:
    """The least time the card could take for ``need``: the larger of its
    operations over the float32 peak and its bytes over the HBM peak."""
    return max(need["flops"] / pk["fp32_flop_per_s"], need["bytes"] / pk["hbm_byte_per_s"])
