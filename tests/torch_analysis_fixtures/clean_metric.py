"""metricslint fixture (torch twin of ``tests/analysis/fixtures/clean_metric.py``,
line for line): a fully clean metric module — the CLI must exit 0.
Exercises the patterns the rules must NOT fire on: loop-declared states,
conditional (if/else) schema alternatives, declared shared-attr latches with
a redeclared identity, schema-only branching, and host work on host-side
(unannotated) inputs.
"""
import torch
from torch import Tensor

STATE_CONSTANT = "extra"


class CleanBase:
    _group_shared_attrs = ("mode",)

    def __init__(self, samplewise: bool = False):
        for s in ("tp", "fp"):
            self.add_state(s, torch.zeros(()), dist_reduce_fx="sum")
        if samplewise:
            self.add_state("scores", [], dist_reduce_fx="cat")
        else:
            self.add_state("scores", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state(STATE_CONSTANT, torch.zeros(()), dist_reduce_fx="sum")
        self.mode = None

    def add_state(self, *a, **k):
        pass

    def update_identity(self):
        return ("clean", 1)

    def update(self, preds: Tensor, target: Tensor):
        if preds.ndim == 1:  # schema branch: static under capture
            preds = preds[None]
        self.mode = "binary"  # declared shared latch
        self.tp = self.tp + torch.sum(preds * target)
        self.fp = self.fp + torch.sum(preds * (1 - target))
        if isinstance(self.scores, list):
            self.scores.append(torch.sum(preds))
        else:
            self.scores = self.scores + torch.sum(preds)
        self.extra.add_(1)  # in place on a declared state: a state write

    def compute(self):
        return self.tp / (self.tp + self.fp)


class CleanOverride(CleanBase):
    """overrides update AND redeclares the identity: hygiene satisfied."""

    def update_identity(self):
        return ("clean-override", 1)

    def update(self, preds: Tensor, target: Tensor):
        self.tp = self.tp + torch.sum(preds * target)
        self.fp = self.fp + torch.sum(preds * (1 - target))


class HostSideText:
    """unannotated host-side inputs (strings): float()/len() are legitimate
    and must not be flagged by the annotation-seeded CLI taint."""

    def __init__(self):
        self.add_state("errors", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, preds, target):
        score = float(len(preds)) / max(float(len(target)), 1.0)
        self.errors = self.errors + torch.tensor(score)

    def compute(self):
        return self.errors
