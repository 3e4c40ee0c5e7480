"""Importable Metric subclasses for the port's probe/planner integration
tests (twins of ``tests/analysis/runtime_fixtures.py``, plus torch-only
cases).

These live in a real module file (not a test body) because the runtime
bridge resolves a class's source via ``inspect.getsourcefile`` — classes
defined in a REPL or exec'd string stay "unknown" by design.
"""
import torch
from torch import nn

from metrics_tpu_torch.core.metric import Metric


class CleanSum(Metric):
    """Straight-line declared-state update: statically verifiable clean."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + torch.sum(x)
        self.count = self.count + x.shape[0]

    def compute(self):
        return self.total / torch.clamp(self.count, min=1)


class LeakyLatch(Metric):
    """update writes an undeclared attribute: statically refutable dirty."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.last_shape = None

    def update(self, x):
        self.last_shape = tuple(x.shape)
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class GroupableClean(Metric):
    """Declares an update_identity and honors the grouping contract."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update_identity(self):
        return ("groupable-clean",)

    def update(self, x):
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class GroupableLeaky(Metric):
    """Declares an update_identity but latches an undeclared attribute —
    the static report must refute its grouping claim."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.rows_seen = 0

    def update_identity(self):
        return ("groupable-leaky",)

    def update(self, x):
        self.rows_seen += x.shape[0]
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class BranchyUnannotated(Metric):
    """Value-dependent python branch with UNANNOTATED params: must stay
    'unknown' (probed), never 'clean' — and never 'dirty' either, since
    eager semantics are perfectly legal."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("pos", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        if float(torch.sum(x)) > 0:
            self.pos = self.pos + torch.sum(x)

    def compute(self):
        return self.pos


# ---- torch only --------------------------------------------------------------


class InPlaceLatch(Metric):
    """update writes an undeclared tensor in place (``add_``): dirty — a
    FakeTensorMode probe compares attributes by identity and cannot see it."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.rows = torch.zeros((), device=self.device)

    def update(self, x):
        self.rows.add_(x.shape[0])
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class DynamicWrite(Metric):
    """``nn.Module.__setattr__`` with a name that is not a literal: the scan
    is unresolved, so the verdict is unknown and the probe decides."""

    def __init__(self, name: str = "latch", **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.latch_name = name

    def update(self, x):
        nn.Module.__setattr__(self, self.latch_name, x.shape[0])
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


def _host_scale(x):
    # a host read the metric pass cannot see: module-level helpers are not
    # scanned (only the class's own methods are)
    return x * (1.0 + 0.0 * x.sum().item())


class HiddenHostRead(Metric):
    """Statically clean, but its update reaches ``.item()`` through a
    module-level helper: the residual case. On the card the CUDA graph
    capture refuses it (``CaptureError``) and the metric runs eagerly from
    then on, its states intact."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + torch.sum(_host_scale(x))

    def compute(self):
        return self.total
