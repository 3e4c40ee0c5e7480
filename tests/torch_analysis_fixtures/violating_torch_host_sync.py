"""metricslint fixture (torch only): the torch host syncs in update — host
copies, an explicit device synchronize, and the ops whose output shape
depends on the data (they read a count back from the device, and no CUDA
graph can hold them).

The CI gate asserts the CLI exits NONZERO on this file.
"""
import torch
from torch import Tensor


class HostCopies:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, preds: Tensor, target: Tensor):
        a = preds.tolist()  # finding: .tolist()
        b = preds.numpy()  # finding: .numpy()
        c = preds.to("cpu")  # finding: .to("cpu")
        d = target.to(device=torch.device("cpu"))  # finding: .to(device=cpu)
        e = preds.to(target.device)  # clean: a device move
        torch.cuda.synchronize()  # finding: torch.cuda.synchronize()
        self.total = self.total + torch.sum(e) + len(a) + len(b) + c.sum() + d.sum()

    def compute(self):
        return self.total


class DataDependentShapes:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, preds: Tensor, target: Tensor):
        hits = preds.nonzero()  # finding: nonzero()
        ids = torch.nonzero(target)  # finding: torch.nonzero()
        labels = torch.unique(target)  # finding: unique()
        picked = preds.masked_select(target > 0)  # finding: masked_select()
        where = torch.where(target > 0)  # finding: one-argument torch.where
        rep = torch.repeat_interleave(preds, target)  # finding: repeat_interleave
        kept = torch.where(target > 0, preds, 0.0)  # clean: three arguments
        twice = preds.repeat_interleave(2)  # clean: a fixed repeat count
        sized = torch.repeat_interleave(preds, target, output_size=8)  # clean: sized
        self.total = self.total + hits.sum() + ids.sum() + labels.sum() + picked.sum()
        self.total = self.total + where[0].sum() + rep.sum() + kept.sum() + twice.sum() + sized.sum()

    def compute(self):
        return self.total
