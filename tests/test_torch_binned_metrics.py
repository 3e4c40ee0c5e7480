"""The port's Binned* PR-curve metrics against the JAX package's.

The TP/FP/FN states are float32 counts (well below 2^24 here) and must be
equal; values (precision, recall, AP, recall at precision) agree at
atol=1e-6, both packages reducing in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port

ATOL = 1e-6
THRESHOLDS = {"int": 100, "list": [0.0, 0.1, 0.25, 0.5, 0.5, 0.75, 0.9, 1.0]}
CLASSES = {
    "BinnedPrecisionRecallCurve": {},
    "BinnedAveragePrecision": {},
    "BinnedRecallAtFixedPrecision": {"min_precision": 0.5},
}


def _batches(num_classes, seed=0, n=200, batches=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        if num_classes == 1:
            preds = rng.rand(n).astype(np.float32)
            target = rng.randint(0, 2, n)
        else:
            preds = rng.rand(n, num_classes).astype(np.float32)
            target = rng.randint(0, num_classes, n)
        # a few preds exactly at thresholds: ties must bin identically
        preds.reshape(-1)[:8] = np.asarray([0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 0.5], np.float32)
        out.append((preds, target))
    return out


def _flatten(x):
    if isinstance(x, (list, tuple)):
        return [y for item in x for y in _flatten(item)]
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


@pytest.mark.parametrize("thresholds", sorted(THRESHOLDS))
@pytest.mark.parametrize("num_classes", [1, 5])
@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_binned_metric_matches_reference(cls, num_classes, thresholds):
    kwargs = dict(num_classes=num_classes, thresholds=THRESHOLDS[thresholds], **CLASSES[cls])
    m_port = getattr(port, cls)(device="cpu", **kwargs)
    m_ref = getattr(ref, cls)(**kwargs)
    for i, (p, t) in enumerate(_batches(num_classes)):
        if i == 0:  # forward: the batch value, and the batch accumulated
            got, want = m_port(torch.from_numpy(p), torch.from_numpy(t)), m_ref(jnp.asarray(p), jnp.asarray(t))
            for g, w in zip(_flatten(got), _flatten(want)):
                np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
        else:
            m_port.update(torch.from_numpy(p), torch.from_numpy(t))
            m_ref.update(jnp.asarray(p), jnp.asarray(t))
    for name in ("TPs", "FPs", "FNs"):
        np.testing.assert_array_equal(getattr(m_port, name).numpy(), np.asarray(getattr(m_ref, name)), err_msg=name)
    got, want = _flatten(m_port.compute()), _flatten(m_ref.compute())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_integer_thresholds_are_the_reference_grid():
    m_port = port.BinnedAveragePrecision(num_classes=1, thresholds=101, device="cpu")
    m_ref = ref.BinnedAveragePrecision(num_classes=1, thresholds=101)
    np.testing.assert_array_equal(m_port.thresholds.numpy(), np.asarray(m_ref.thresholds))


def test_bad_thresholds_raise():
    with pytest.raises(ValueError, match="thresholds"):
        port.BinnedPrecisionRecallCurve(num_classes=1, thresholds=None, device="cpu")
