"""metricslint fixture (torch only): in-place writes on undeclared tensor
attributes. Tensors are mutable: a method in the in-place convention
(``add_``), an ``out=`` argument and item assignment write the attribute as
surely as ``self.x = ...`` rebinds it.

The CI gate asserts the CLI exits NONZERO on this file.
"""
import torch
from torch import Tensor


class InPlaceMethodLatch:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.seen = torch.zeros(())
        self.hist = torch.zeros(10)
        self.acc = torch.zeros(())

    def add_state(self, *a, **k):
        pass

    def update(self, x: Tensor):
        self.total.add_(torch.sum(x))  # clean: in place on a declared state
        self.seen.add_(1)  # finding: undeclared-state (add_)
        self.hist.index_add_(0, x.long(), torch.ones_like(x))  # finding (index_add_)
        buf = self.acc
        buf.zero_()  # finding: undeclared-state (through an alias)

    def compute(self):
        return self.total


class OutArgumentLatch:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.scratch = torch.zeros(4)

    def add_state(self, *a, **k):
        pass

    def update(self, x: Tensor):
        torch.mul(x, 2.0, out=self.scratch)  # finding: undeclared-state (out=)
        torch.add(self.total, torch.sum(x), out=self.total)  # clean: a declared state

    def compute(self):
        return self.total


class ItemAssignLatch:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.last = torch.zeros(3)

    def add_state(self, *a, **k):
        pass

    def update(self, x: Tensor):
        self.last[0] = x[0]  # finding: undeclared-state (item assignment)
        self.last.data = x[:3]  # finding: undeclared-state (.data)
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class DynamicWriteStaysSilent:
    """a setattr whose name is not a literal: the declared set cannot be
    checked, the scan is unresolved (the runtime verdict: unknown), and the
    CLI reports nothing."""

    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, x: Tensor, name: str = "latch"):
        torch.nn.Module.__setattr__(self, name, x)
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total
