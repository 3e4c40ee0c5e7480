"""metricslint fixture (torch twin, line for line): declaration hygiene — redeclare,
unshared latches, statically-wrong add_state defaults.

The CI gate asserts the CLI exits NONZERO on this file.
"""
import torch


class FamilyBase:
    """declares a grouping key: its update is a correctness promise."""

    _group_shared_attrs = ("mode",)

    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.mode = None

    def add_state(self, *a, **k):
        pass

    def update_identity(self):
        return ("family", 1)

    def update(self, x):
        self.mode = "binary"  # clean: declared in _group_shared_attrs
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class OverridesUpdateOnly(FamilyBase):
    """finding: update-identity-redeclare — inherits FamilyBase's key but
    replaces the update it described; the runtime silently drops the key."""

    def update(self, x):  # finding on this line
        self.total = self.total + torch.sum(x) * 2


class UnsharedLatchFamily(FamilyBase):
    """finding: unshared-latch — declares (inherits) an identity, but its
    update mutates an attribute missing from _group_shared_attrs."""

    def update_identity(self):
        return ("unshared", 1)

    def update(self, x):
        self.num_classes = int(x.shape[-1])  # finding: unshared-latch
        self.total = self.total + torch.sum(x)


class BadDefaults:
    def __init__(self):
        # finding: state-default (non-empty list default)
        self.add_state("filled", [1, 2], dist_reduce_fx="cat")
        # finding: state-default (invalid fx literal)
        self.add_state("bad_fx", torch.zeros(()), dist_reduce_fx="prod")
        # finding: state-default (growing list with reduce-style fx)
        self.add_state("list_sum", [], dist_reduce_fx="sum")
        # finding: state-default (0-d default on a 'cat' state)
        self.add_state("scalar_cat", torch.zeros(()), dist_reduce_fx="cat")
        # finding: state-default (duplicate declaration)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def add_state(self, *a, **k):
        pass

    def update(self, x):
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total
