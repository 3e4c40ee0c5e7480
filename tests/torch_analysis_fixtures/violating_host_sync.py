"""metricslint fixture (torch twin, line for line): host syncs in update.

The CI gate asserts the CLI exits NONZERO on this file.
"""
import numpy as np
import torch
from torch import Tensor



class FloatOnTraced:
    def __init__(self):
        self.add_state("pos", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, preds: Tensor):
        if float(torch.sum(preds)) > 0:  # finding: host-sync-in-update
            self.pos = self.pos + torch.sum(preds)

    def compute(self):
        return self.pos


class ItemOnState:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, preds: Tensor):
        self.total = self.total + torch.sum(preds)
        _ = self.total.item()  # finding: host-sync-in-update

    def compute(self):
        return self.total


class NumpyRoundTrip:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, preds: Tensor):
        host = np.asarray(preds)  # finding: host-sync-in-update
        self.total = self.total + torch.sum(torch.as_tensor(host))

    def compute(self):
        return self.total


class DeviceGetInUpdate:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, preds: Tensor):
        host = preds.cpu()  # finding: host-sync-in-update (.cpu())
        self.total = self.total + torch.sum(torch.as_tensor(host))

    def compute(self):
        return self.total


class TaintThroughLocals:
    """the sync target is two assignments away from the traced input."""

    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, preds: Tensor):
        scaled = preds * 2.0
        summed = torch.sum(scaled)
        _ = int(summed)  # finding: host-sync-in-update (via taint chain)
        self.total = self.total + summed

    def compute(self):
        return self.total
