"""CalibrationError, KLDivergence, Hinge and AverageMeter in the port against
the JAX package, on the same numpy inputs, functional and module.

One size (N = 32 rows, C = 5 classes) serves every case: the JAX side
compiles each op once per shape. Float values compare at 1e-6, plus 4
float32 ulps of their size (rtol 2**-22): they are float32 sums of up to
32 terms added in another order, which may differ by log2(32) = 5 roundings
of 2**-24 each, and the hinge and KL sums reach about 13, where one ulp is
already 9.5e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional as ref_fn
import metrics_tpu_torch as port
import metrics_tpu_torch.functional as port_fn
from metrics_tpu_torch.utils.data import _linspace_like_reference

ATOL, RTOL = 1e-6, 2.0 ** -22
N, C = 32, 5

_rng = np.random.RandomState(5)
PROBS = _rng.rand(2, N, C).astype(np.float32)
PROBS /= PROBS.sum(-1, keepdims=True)
LABELS = _rng.randint(0, C, (2, N))
BINARY = _rng.rand(2, N).astype(np.float32)
BINARY[0, :4] = [0.0, 1.0, 0.4, 1 / 15]  # a confidence of 0 (in no bin), 1, and on bin edges
BINARY_TARGET = _rng.randint(0, 2, (2, N))
MDMC_PROBS = _rng.rand(2, 4, C, 8).astype(np.float32)
MDMC_LABELS = _rng.randint(0, C, (2, 4, 8))
LOGITS = (_rng.randn(2, N, C) * 2).astype(np.float32)
DECISIONS = (_rng.randn(2, N) * 2).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _drive(m_port, m_ref, batches, forward=False):
    """Feed both the same batches (comparing each batch value with
    ``forward``), then compare the accumulated values."""
    for args in batches:
        t_args = [torch.from_numpy(np.asarray(a)) for a in args]
        j_args = [jnp.asarray(a) for a in args]
        if forward:
            _assert_close(m_port(*t_args), m_ref(*j_args))
        else:
            m_port.update(*t_args)
            m_ref.update(*j_args)
    _assert_close(m_port.compute(), m_ref.compute())


# ---------------------------------------------------------------------------
# CalibrationError
# ---------------------------------------------------------------------------

def test_bin_boundaries_are_the_reference_linspace():
    got = _linspace_like_reference(16).numpy()
    want = np.asarray(jnp.linspace(0, 1, 16, dtype=jnp.float32))
    np.testing.assert_array_equal(got, want)
    # torch.linspace rounds 6 of the 16 default boundaries otherwise
    assert int((torch.linspace(0, 1, 16).numpy() != want).sum()) == 6


CE_CASES = {
    "binary": (BINARY, BINARY_TARGET),
    "multiclass": (PROBS, LABELS),
    "multidim": (MDMC_PROBS, MDMC_LABELS),
}


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_calibration_error_matches_reference(case, norm):
    preds, target = CE_CASES[case]
    _drive(port.CalibrationError(n_bins=15, norm=norm, device="cpu"), ref.CalibrationError(n_bins=15, norm=norm),
           zip(preds, target))
    _assert_close(port_fn.calibration_error(torch.from_numpy(preds[0]), torch.from_numpy(target[0]), 7, norm),
                  ref_fn.calibration_error(jnp.asarray(preds[0]), jnp.asarray(target[0]), 7, norm))


def test_calibration_error_debiased_l2_and_errors():
    from metrics_tpu.functional.classification.calibration_error import _ce_compute as ref_ce
    from metrics_tpu_torch.functional.classification.calibration_error import _ce_compute

    conf, acc = BINARY[1], BINARY_TARGET[1].astype(np.float32)
    _assert_close(_ce_compute(torch.from_numpy(conf), torch.from_numpy(acc), _linspace_like_reference(16), "l2", True),
                  ref_ce(jnp.asarray(conf), jnp.asarray(acc), jnp.linspace(0, 1, 16), "l2", True))
    with pytest.raises(ValueError, match="Norm l3 is not supported"):
        port.CalibrationError(norm="l3", device="cpu")
    with pytest.raises(ValueError, match="`n_bins` to be a int larger than 0"):
        port_fn.calibration_error(torch.zeros(3), torch.zeros(3, dtype=torch.long), n_bins=0)
    with pytest.raises(ValueError, match="not well-defined"):
        port_fn.calibration_error(torch.from_numpy(PROBS[0]), torch.from_numpy(_rng.randint(0, 2, (N, C))))


def test_calibration_error_with_capacity_equals_list_states():
    m_list, m_cap = port.CalibrationError(device="cpu"), port.CalibrationError(device="cpu").with_capacity(2 * N)
    for p, t in zip(PROBS, LABELS):
        m_list.update(torch.from_numpy(p), torch.from_numpy(t))
        m_cap.update(torch.from_numpy(p), torch.from_numpy(t))
    assert isinstance(m_cap.confidences, port.CatBuffer) and len(m_cap.confidences) == 2 * N
    assert torch.equal(m_cap.compute(), m_list.compute())


# ---------------------------------------------------------------------------
# KLDivergence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("log_prob", [False, True])
def test_kl_divergence_matches_reference(log_prob, reduction):
    if log_prob:
        p = np.log(PROBS)
        q = np.log(np.roll(PROBS, 1, axis=-1))
    else:
        p, q = PROBS, np.roll(PROBS, 1, axis=-1) * 3.0  # unnormalized q is normalized
    _drive(port.KLDivergence(log_prob=log_prob, reduction=reduction, device="cpu"),
           ref.KLDivergence(log_prob=log_prob, reduction=reduction), zip(p, q), forward=True)
    _assert_close(port_fn.kl_divergence(torch.from_numpy(p[0]), torch.from_numpy(q[0]), log_prob, reduction),
                  ref_fn.kl_divergence(jnp.asarray(p[0]), jnp.asarray(q[0]), log_prob, reduction))


def test_kl_divergence_errors():
    with pytest.raises(TypeError, match="`log_prob` to be bool"):
        port.KLDivergence(log_prob=1, device="cpu")
    with pytest.raises(ValueError, match="`reduction` to be one of"):
        port.KLDivergence(reduction="max", device="cpu")
    with pytest.raises(ValueError, match="to be 2D"):
        port_fn.kl_divergence(torch.rand(3), torch.rand(3))


# ---------------------------------------------------------------------------
# Hinge
# ---------------------------------------------------------------------------

HINGE_CASES = [
    ("binary", None),
    ("multiclass", None),
    ("multiclass", "crammer-singer"),
    ("multiclass", "one-vs-all"),
]


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("case,mode", HINGE_CASES)
def test_hinge_matches_reference(case, mode, squared):
    preds, target = (DECISIONS, BINARY_TARGET) if case == "binary" else (LOGITS, LABELS)
    _drive(port.Hinge(squared=squared, multiclass_mode=mode, device="cpu"),
           ref.Hinge(squared=squared, multiclass_mode=mode), zip(preds, target), forward=True)
    _assert_close(port_fn.hinge(torch.from_numpy(preds[0]), torch.from_numpy(target[0]), squared, mode),
                  ref_fn.hinge(jnp.asarray(preds[0]), jnp.asarray(target[0]), squared, mode))


def test_hinge_errors():
    with pytest.raises(ValueError, match="`multiclass_mode` should be either"):
        port.Hinge(multiclass_mode="one-vs-one", device="cpu")
    with pytest.raises(ValueError, match="should be one dimensional"):
        port_fn.hinge(torch.rand(4, 3), torch.zeros(4, 3, dtype=torch.long))
    with pytest.raises(ValueError, match="should be one or two dimensional"):
        port_fn.hinge(torch.rand(4, 3, 2), torch.zeros(4, dtype=torch.long))


# ---------------------------------------------------------------------------
# AverageMeter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_average_meter_matches_reference(weighted):
    values = [BINARY[0], BINARY[1][:5], np.float32(2.5)]
    weights = [BINARY[1], np.float32(0.5), np.float32(3.0)] if weighted else [1.0, 1.0, 1.0]
    m_port, m_ref = port.AverageMeter(device="cpu"), ref.AverageMeter()
    for v, w in zip(values, weights):
        _assert_close(m_port(torch.as_tensor(v), torch.as_tensor(w)), m_ref(jnp.asarray(v), jnp.asarray(w)))
    _assert_close(m_port.compute(), m_ref.compute())
    assert m_port.value.dtype == torch.float32 and m_port.weight.dtype == torch.float32
