"""Static pre-classification on the card. It imports nothing of JAX, so that
it runs on a machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_analysis_cuda.py

Without a card each case skips inside the test. A "clean" verdict skips the
FakeTensorMode probe; a host read the analysis cannot see is then found by
the CUDA graph capture, which refuses it before anything ran: the metric
falls back to eager for good with its states intact.
"""
import numpy as np
import pytest
import torch

import metrics_tpu_torch as port
from metrics_tpu_torch.analysis.runtime import static_probe_verdict
from metrics_tpu_torch.core.metric import Metric

# The classes live in this module (the runtime bridge reads a class's source
# file), not in tests/helpers: the card's machine has a foreign ``tests``
# package on its path.


def _host_scale(x):
    # a host read the metric pass cannot see: module-level helpers are not
    # scanned (only the class's own methods are)
    return x * (1.0 + 0.0 * x.sum().item())


class HiddenHostRead(Metric):
    """Statically clean; its update reaches ``.item()`` through a helper."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + torch.sum(_host_scale(x))

    def compute(self):
        return self.total


class InPlaceLatch(Metric):
    """update writes an undeclared tensor in place: statically dirty."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.rows = torch.zeros((), device=self.device)

    def update(self, x):
        self.rows.add_(x.shape[0])
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batches(device, n=20):
    rng = np.random.RandomState(5)
    return [torch.from_numpy(rng.rand(64).astype(np.float32)).to(device) for _ in range(n)]


@pytest.mark.cuda
def test_hidden_host_read_fails_capture_and_runs_eagerly_with_its_states_intact():
    device = _card()
    assert static_probe_verdict(HiddenHostRead(device=device), ("update",))[0] == "clean"
    m, eager = HiddenHostRead(device=device), HiddenHostRead(device=device)
    m.compiled_update = True
    eager.compiled_update = False
    for b in _batches(device):
        m.update(b)
        eager.update(b)
    stats = m.compile_stats()
    assert stats["dispatches"] == 0 and "compiled dispatch failed" in stats["fallback"]["update"]
    assert torch.equal(m.total, eager.total)
    # later work on the card, compiled included, is still right
    clean, ref = port.MeanSquaredError(device=device), port.MeanSquaredError(device=device)
    clean.compiled_update, ref.compiled_update = True, False
    batches = _batches(device)
    for b, t in zip(batches, batches[1:] + batches[:1]):
        clean.update(b, t)
        ref.update(b, t)
    assert clean.compile_stats()["dispatches"] > 0 and torch.equal(clean.compute(), ref.compute())


@pytest.mark.cuda
def test_statically_dirty_class_falls_back_before_any_capture():
    device = _card()
    m = InPlaceLatch(device=device)
    m.compiled_update = True
    for b in _batches(device, 4):
        m.update(b)
    stats = m.compile_stats()
    assert stats["traces"] == 0 and stats["dispatches"] == 0
    assert "self.rows" in stats["fallback"]["update"] and "test_torch_analysis_cuda.py:" in stats["fallback"]["update"]
    assert float(m.rows) == 4 * 64
