"""metricslint fixture (torch twin, line for line): undeclared-state variants.

Never imported by tests — the checker is pure AST — but kept import-safe.
The CI gate asserts the CLI exits NONZERO on this file.
"""
import torch


class PlainAssignLatch:
    """update assigns an attribute no add_state declares."""

    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):  # stand-in so the file imports standalone
        pass

    def update(self, x):
        self.seen = True  # finding: undeclared-state
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class InPlaceContainerLatch:
    """update mutates an undeclared container in place (append / [k]=)."""

    def __init__(self):
        self.add_state("rows", [], dist_reduce_fx="cat")
        self.shapes = []
        self.by_kind = {}

    def add_state(self, *a, **k):
        pass

    def update(self, x):
        self.shapes.append(x.shape)  # finding: undeclared-state (in place)
        self.by_kind["n"] = 1  # finding: undeclared-state (in place)
        self.rows.append(x)  # clean: declared cat state

    def compute(self):
        return self.rows


class AugAssignLatch:
    """augmented assignment on an undeclared attribute."""

    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.calls = 0

    def add_state(self, *a, **k):
        pass

    def update(self, x):
        self.calls += 1  # finding: undeclared-state
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class HelperWriterLatch:
    """the write hides one self-method call away from update."""

    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def _note(self, x):
        self.last_batch = x  # finding: undeclared-state (via helper)

    def update(self, x):
        self._note(x)
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class ComputeWriterLatch:
    """compute() caches into an undeclared attribute."""

    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, x):
        self.total = self.total + torch.sum(x)

    def compute(self):
        self.cached = self.total  # finding: undeclared-state
        return self.cached
