"""metricslint fixture (torch twin, line for line): real violations, every
one suppressed — the CLI must exit 0. Exercises all three suppression forms:
same-line, line-above, and def-line (whole-function) scope, plus ``all``.
"""
import torch
import torch.distributed as dist
from torch import Tensor


def _gather(x, group=None, timeout=None):
    return [torch.as_tensor(x)]


class SameLineSuppressed:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, x: Tensor):
        self.seen = True  # metricslint: disable=undeclared-state
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class LineAboveSuppressed:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, x: Tensor):
        # metricslint: disable=host-sync-in-update
        _ = float(torch.sum(x))
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class DefLineSuppressed:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, x: Tensor):  # metricslint: disable=all
        self.calls = 1
        _ = float(torch.sum(x))
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


def rank_guarded_but_waived(x):  # metricslint: disable=rank-dependent-collective
    if dist.get_rank() == 0:
        return _gather(x)
    return x
