"""Precision, Recall, FBeta, F1, Specificity and HammingDistance of the port
against the JAX package, module and functional, on the same numpy inputs.

Counts compare exactly by value (int32 there, int64 here). Float values
compare at atol=1e-6: both reduce in float32, in another order. Where the JAX
package raises ``ValueError`` for an argument combination, the port must
raise it too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional as ref_fn
import metrics_tpu_torch as port
import metrics_tpu_torch.functional as port_fn

ATOL = 1e-6
# one size for the batch, the classes and the extra dimension: the JAX side
# compiles each new shape once, and this keeps the shapes few
N = C = X = 10


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def _inputs(kind, seed):
    """(preds, target) numpy pairs of each input kind."""
    rng = np.random.RandomState(seed)
    if kind == "binary":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
    if kind == "multilabel":
        return rng.rand(N, C).astype(np.float32), rng.randint(0, 2, (N, C))
    if kind == "multiclass":
        return rng.rand(N, C).astype(np.float32), rng.randint(0, C, N)
    if kind == "multiclass_labels":
        return rng.randint(0, C, N), rng.randint(0, C, N)
    # multi-dim multi-class: [N, C, X] probabilities, [N, X] labels
    return rng.rand(N, C, X).astype(np.float32), rng.randint(0, C, (N, X))


# (input kind, keyword arguments); num_classes is added for every kind but binary
CASES = (
    [("multiclass", dict(average=a)) for a in ("micro", "macro", "weighted", "none", "samples")]
    + [("multilabel", dict(average=a)) for a in ("micro", "macro", "weighted", "none", "samples")]
    + [("mdmc", dict(average=a, mdmc_average=m))
       for m in ("global", "samplewise") for a in ("micro", "macro", "weighted", "none", "samples")]
    + [("binary", dict(average="micro")), ("multiclass_labels", dict(average="macro"))]
    + [("multiclass", dict(average=a, ignore_index=1)) for a in ("micro", "macro", "weighted", "none")]
    + [("multiclass", dict(average=a, top_k=2)) for a in ("micro", "macro")]
)
FUNCTIONS = {
    "precision": {},
    "recall": {},
    "fbeta": dict(beta=0.5),
    "f1": {},
    "specificity": {},
}


def _kwargs(kind, kwargs):
    return kwargs if kind == "binary" else dict(kwargs, num_classes=C)


def _case_id(case):
    kind, kwargs = case
    return "-".join([kind] + [f"{k}={v}" for k, v in sorted(kwargs.items())])


def _ref_or_error(fn):
    try:
        return fn(), None
    except ValueError as err:
        return None, err


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_functional_matches_reference(name, case):
    kind, kwargs = case
    kwargs = dict(_kwargs(kind, kwargs), **FUNCTIONS[name])
    p, t = _inputs(kind, seed=len(name))
    want, err = _ref_or_error(lambda: getattr(ref_fn, name)(jnp.asarray(p), jnp.asarray(t), **kwargs))
    if err is not None:
        with pytest.raises(ValueError):
            getattr(port_fn, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
        return
    _assert_close(getattr(port_fn, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs), want)


def test_precision_recall_matches_reference():
    p, t = _inputs("multiclass", seed=3)
    got = port_fn.precision_recall(torch.from_numpy(p), torch.from_numpy(t), average="macro", num_classes=C)
    want = ref_fn.precision_recall(jnp.asarray(p), jnp.asarray(t), average="macro", num_classes=C)
    for g, w in zip(got, want):
        _assert_close(g, w)


MODULE_CASES = [
    ("multiclass", dict(average="macro")),
    ("multiclass", dict(average="none", ignore_index=2)),
    ("multilabel", dict(average="weighted")),
    ("mdmc", dict(average="macro", mdmc_average="samplewise")),
    ("mdmc", dict(average="micro", mdmc_average="global")),
    ("binary", dict(average="micro")),
]
MODULES = {"Precision": {}, "Recall": {}, "FBeta": dict(beta=2.0), "F1": {}, "Specificity": {}}


@pytest.mark.parametrize("cls", sorted(MODULES))
@pytest.mark.parametrize("case", MODULE_CASES, ids=_case_id)
def test_module_matches_reference(cls, case):
    kind, kwargs = case
    kwargs = dict(_kwargs(kind, kwargs), **MODULES[cls])
    m_port, m_ref = getattr(port, cls)(device="cpu", **kwargs), getattr(ref, cls)(**kwargs)
    for seed in (0, 1):
        p, t = _inputs(kind, seed)
        _assert_close(m_port(torch.from_numpy(p), torch.from_numpy(t)), m_ref(jnp.asarray(p), jnp.asarray(t)))
    for name in m_ref._defaults:
        got, want = m_port._state[name], m_ref._state[name]
        if isinstance(want, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _assert_close(g, w)
        else:
            _assert_close(got, want)
    _assert_close(m_port.compute(), m_ref.compute())


@pytest.mark.parametrize("kind", ["binary", "multilabel", "multiclass", "mdmc"])
def test_hamming_distance_matches_reference(kind):
    m_port, m_ref = port.HammingDistance(device="cpu"), ref.HammingDistance()
    for seed in (0, 1):
        p, t = _inputs(kind, seed)
        _assert_close(m_port(torch.from_numpy(p), torch.from_numpy(t)), m_ref(jnp.asarray(p), jnp.asarray(t)))
        _assert_close(port_fn.hamming_distance(torch.from_numpy(p), torch.from_numpy(t), threshold=0.3),
                      ref_fn.hamming_distance(jnp.asarray(p), jnp.asarray(t), threshold=0.3))
    _assert_close(m_port.correct, m_ref.correct)
    _assert_close(m_port.total, m_ref.total)
    _assert_close(m_port.compute(), m_ref.compute())


@pytest.mark.parametrize("kwargs", [
    dict(average="bogus"),
    dict(average="macro"),
    dict(average="micro", mdmc_average="bogus"),
    dict(average="micro", num_classes=3, ignore_index=5),
], ids=["average", "macro-without-classes", "mdmc", "ignore-index"])
def test_invalid_arguments_raise_like_the_reference(kwargs):
    for cls in ("Precision", "Specificity", "FBeta"):
        with pytest.raises(ValueError):
            getattr(ref, cls)(**kwargs)
        with pytest.raises(ValueError):
            getattr(port, cls)(device="cpu", **kwargs)
    p, t = _inputs("multiclass", 0)
    with pytest.raises(ValueError):
        ref_fn.precision(jnp.asarray(p), jnp.asarray(t), **kwargs)
    with pytest.raises(ValueError):
        port_fn.precision(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
