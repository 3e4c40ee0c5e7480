"""Three faults of the port's classification code, held against the JAX
package on the same numpy inputs:

- ``mdmc_average="samplewise"`` on input that is not multi-dim multi-class
  raises ``IndexError`` in both packages' functionals (the scores reduce to
  one scalar, which ``jnp.mean(axis=0)`` refuses); the module forms return
  the same value in both;
- ``functional.kldivergence``, the deprecated alias, warns as the JAX
  package does and returns ``kl_divergence``'s value;
- invalid inputs raise the JAX package's exception class (``ValueError`` or
  ``TypeError``), not torch's ``RuntimeError`` or ``IndexError``.

Only exception classes and one float value are compared; the value is the
same float32 computation on 8 terms, at ``ATOL = 1e-6``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional as ref_fn
import metrics_tpu_torch as port
import metrics_tpu_torch.functional as port_fn

ATOL = 1e-6
N, C = 24, 4

_rng = np.random.RandomState(9)
INPUTS = {
    "binary-probs": (_rng.rand(N).astype(np.float32), _rng.randint(0, 2, N), None),
    "binary-labels": (_rng.randint(0, 2, N), _rng.randint(0, 2, N), None),
    "multiclass-probs": (_rng.dirichlet(np.ones(C), N).astype(np.float32), _rng.randint(0, C, N), C),
    "multiclass-labels": (_rng.randint(0, C, N), _rng.randint(0, C, N), C),
    "multilabel-probs": (_rng.rand(N, 3).astype(np.float32), _rng.randint(0, 2, (N, 3)), 3),
}
MDMC = (_rng.dirichlet(np.ones(C), (6, 5)).transpose(0, 2, 1).astype(np.float32), _rng.randint(0, C, (6, 5)))


def _jax(*xs):
    return [jnp.asarray(x) for x in xs]


def _torch(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _raised(fn):
    """The class of the exception ``fn()`` raises, or None."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            fn()
        except Exception as err:  # noqa: BLE001 - the class is the result
            return type(err)
    return None


# ---------------------------------------------------------------------------
# C.1: samplewise averaging of input that is not multi-dim multi-class
# ---------------------------------------------------------------------------

SAMPLEWISE_FUNCTIONALS = {
    "accuracy": {},
    "precision": {},
    "recall": {},
    "fbeta": {"beta": 1.0},
    "specificity": {},
}


def _samplewise_kwargs(name, num_classes):
    kw = dict(SAMPLEWISE_FUNCTIONALS[name], mdmc_average="samplewise")
    if num_classes:
        kw["num_classes"] = num_classes
    return kw


@pytest.mark.parametrize("case", INPUTS)
@pytest.mark.parametrize("name", SAMPLEWISE_FUNCTIONALS)
def test_samplewise_on_flat_input_raises_like_reference(name, case):
    p, t, nc = INPUTS[case]
    kw = _samplewise_kwargs(name, nc)
    want = _raised(lambda: getattr(ref_fn, name)(*_jax(p, t), **kw))
    assert want is IndexError
    with pytest.raises(IndexError, match="not multi-dim multi-class"):
        getattr(port_fn, name)(*_torch(p, t), **kw)


@pytest.mark.parametrize("name", SAMPLEWISE_FUNCTIONALS)
def test_samplewise_on_multidim_input_matches_reference(name):
    kw = _samplewise_kwargs(name, C)
    got = getattr(port_fn, name)(*_torch(*MDMC), **kw)
    want = getattr(ref_fn, name)(*_jax(*MDMC), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


SAMPLEWISE_MODULES = {
    "accuracy": "Accuracy",
    "precision": "Precision",
    "recall": "Recall",
    "fbeta": "FBeta",
    "specificity": "Specificity",
}


@pytest.mark.parametrize("case", INPUTS)
@pytest.mark.parametrize("name", SAMPLEWISE_MODULES)
def test_samplewise_module_on_flat_input_matches_reference(name, case):
    """The module forms accumulate per-sample statistics under
    ``mdmc_average="samplewise"``, so their scores are not one scalar and
    neither package raises: the port returns the JAX value."""
    p, t, nc = INPUTS[case]
    kw = _samplewise_kwargs(name, nc)
    cls = SAMPLEWISE_MODULES[name]
    m_ref, m_port = getattr(ref, cls)(**kw), getattr(port, cls)(device="cpu", **kw)
    m_ref.update(*_jax(p, t))
    m_port.update(*_torch(p, t))
    np.testing.assert_allclose(m_port.compute().numpy(), np.asarray(m_ref.compute()), atol=ATOL)


# ---------------------------------------------------------------------------
# C.2: the deprecated functional.kldivergence
# ---------------------------------------------------------------------------

def test_kldivergence_alias_warns_and_matches_reference():
    p = _rng.rand(8, C).astype(np.float32)
    q = _rng.rand(8, C).astype(np.float32)
    with pytest.warns(DeprecationWarning) as want_warnings:
        want = ref_fn.kldivergence(*_jax(p, q))
    with pytest.warns(DeprecationWarning) as got_warnings:
        got = port_fn.kldivergence(*_torch(p, q))
    assert [str(w.message) for w in got_warnings] == [str(w.message) for w in want_warnings]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), port_fn.kl_divergence(*_torch(p, q)).numpy(), atol=0.0)
    assert "kldivergence" in port_fn.__all__


# ---------------------------------------------------------------------------
# C.3: the JAX package's exception classes on invalid input
# ---------------------------------------------------------------------------

_EMPTY_PROBS, _EMPTY_LABELS = np.zeros((0, C), np.float32), np.zeros((0,), np.int64)
_MC_PROBS, _MC_LABELS = INPUTS["multiclass-probs"][:2]
_ML_LABELS = _rng.randint(0, 2, (N, 3))
_MDMC_LABELS = _rng.randint(0, C, (6, 5))

INVALID = {
    "confmat-multilabel-on-multiclass": ("confusion_matrix", _MC_PROBS, _MC_LABELS,
                                         {"num_classes": C, "multilabel": True}),
    "confmat-multilabel-on-labels": ("confusion_matrix", INPUTS["multiclass-labels"][0], _MC_LABELS,
                                     {"num_classes": C, "multilabel": True}),
    "confmat-multilabel-on-mdmc": ("confusion_matrix", _MDMC_LABELS, _rng.randint(0, C, (6, 5)),
                                   {"num_classes": C, "multilabel": True}),
    "calibration-on-labels": ("calibration_error", INPUTS["multiclass-labels"][0], _MC_LABELS, {}),
    "calibration-on-binary-labels": ("calibration_error", *INPUTS["binary-labels"][:2], {}),
    "calibration-on-mdmc-labels": ("calibration_error", _MDMC_LABELS, _rng.randint(0, C, (6, 5)), {}),
    "auroc-weighted-multilabel-labels": ("auroc", _ML_LABELS, _rng.randint(0, 2, (N, 3)),
                                         {"num_classes": 3, "average": "weighted"}),
    "auroc-weighted-mdmc-labels": ("auroc", _MDMC_LABELS, _rng.randint(0, 2, (6, 5)),
                                   {"num_classes": C, "average": "weighted"}),
    **{f"empty-{name}": (name, _EMPTY_PROBS, _EMPTY_LABELS, kw) for name, kw in {
        "accuracy": {},
        "precision": {"num_classes": C, "average": "macro"},
        "recall": {},
        "f1": {},
        "specificity": {},
        "stat_scores": {},
        "hamming_distance": {},
        "confusion_matrix": {"num_classes": C},
        "cohen_kappa": {"num_classes": C},
        "matthews_corrcoef": {"num_classes": C},
        "iou": {"num_classes": C},
        "auroc": {"num_classes": C},
        "calibration_error": {},
        "average_precision": {"num_classes": C},
        "roc": {"num_classes": C},
        "precision_recall_curve": {"num_classes": C},
    }.items()},
    "empty-binary-accuracy": ("accuracy", np.zeros((0,), np.float32), _EMPTY_LABELS, {}),
    "empty-binary-roc": ("roc", np.zeros((0,), np.float32), _EMPTY_LABELS, {}),
    "empty-labels-iou": ("iou", _EMPTY_LABELS, _EMPTY_LABELS, {}),
}


@pytest.mark.parametrize("case", INVALID)
def test_invalid_input_raises_the_reference_class(case):
    name, p, t, kw = INVALID[case]
    want = _raised(lambda: getattr(ref_fn, name)(*_jax(p, t), **kw))
    assert want in (ValueError, TypeError), want
    assert _raised(lambda: getattr(port_fn, name)(*_torch(p, t), **kw)) is want


@pytest.mark.parametrize("cls, kw", [
    ("Accuracy", {}),
    ("ConfusionMatrix", {"num_classes": C}),
    ("AUROC", {"num_classes": C}),
    ("CalibrationError", {}),
], ids=["Accuracy", "ConfusionMatrix", "AUROC", "CalibrationError"])
def test_empty_batch_module_raises_the_reference_class(cls, kw):
    def run(package, make_inputs, **extra):
        m = getattr(package, cls)(**kw, **extra)
        m.update(*make_inputs(_EMPTY_PROBS, _EMPTY_LABELS))
        return m.compute()

    want = _raised(lambda: run(ref, _jax))
    assert want is ValueError
    assert _raised(lambda: run(port, _torch, device="cpu")) is want
