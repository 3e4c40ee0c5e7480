"""ConfusionMatrix, IoU, CohenKappa, MatthewsCorrcoef, dice_score and the
scatter count under them, in the port against the JAX package, on the same
numpy inputs.

Counts compare exactly by value (int32 there, int64 here). Float values
compare at atol=1e-6: both cast the counts to float32 at the same points and
reduce in float32, in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional as ref_fn
import metrics_tpu_torch as port
import metrics_tpu_torch.functional as port_fn
from metrics_tpu.utils.data import _bincount as ref_bincount
from metrics_tpu_torch.utils.data import _bincount, get_num_classes, to_categorical

ATOL = 1e-6
# one size for the batch and the classes: the JAX side compiles each new
# shape once, and this keeps the shapes few
N = C = 10


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
    """(preds, target) numpy pairs; "sparse" labels leave classes 4, 6 and 7
    out, and reach the last class (so that inferring the classes gives C)."""
    rng = np.random.RandomState(seed)
    if kind == "sparse":
        present = np.array([0, 1, 2, 3, 5, 8, C - 1])
        return present[rng.randint(0, 7, N)], np.concatenate([[C - 1], present[rng.randint(0, 7, N - 1)]])
    if kind == "binary":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
    if kind == "multilabel":
        return rng.rand(N, C).astype(np.float32), rng.randint(0, 2, (N, C))
    if kind == "labels":
        return rng.randint(0, C, N), rng.randint(0, C, N)
    return rng.rand(N, C).astype(np.float32), rng.randint(0, C, N)


def _drive(m_port, m_ref, kind, forward=False):
    """Feed both the same batches (with ``forward``, comparing each batch
    value), then compare the states and the values."""
    for seed in (0, 1):
        p, t = _inputs(kind, seed)
        if forward:
            _assert_close(m_port(torch.from_numpy(p), torch.from_numpy(t)), m_ref(jnp.asarray(p), jnp.asarray(t)))
        else:
            m_port.update(torch.from_numpy(p), torch.from_numpy(t))
            m_ref.update(jnp.asarray(p), jnp.asarray(t))
    _assert_close(m_port.confmat, m_ref.confmat)
    _assert_close(m_port.compute(), m_ref.compute())


@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize("kind", ["probs", "labels"])
def test_confusion_matrix_matches_reference(kind, normalize):
    m_port, m_ref = port.ConfusionMatrix(C, normalize=normalize, device="cpu"), ref.ConfusionMatrix(C, normalize=normalize)
    _drive(m_port, m_ref, kind, forward=normalize is None)
    p, t = _inputs(kind, 2)
    _assert_close(port_fn.confusion_matrix(torch.from_numpy(p), torch.from_numpy(t), C, normalize=normalize),
                  ref_fn.confusion_matrix(jnp.asarray(p), jnp.asarray(t), C, normalize=normalize))


@pytest.mark.parametrize("kind,num_classes,kwargs", [
    ("multilabel", C, dict(multilabel=True, threshold=0.3)),
    ("binary", 2, dict(normalize="pred")),
], ids=["multilabel", "binary"])
def test_confusion_matrix_multilabel_and_binary(kind, num_classes, kwargs):
    _drive(port.ConfusionMatrix(num_classes, device="cpu", **kwargs), ref.ConfusionMatrix(num_classes, **kwargs), kind)


@pytest.mark.parametrize("kwargs", [
    {},
    dict(ignore_index=0),
    dict(ignore_index=3, reduction="none"),
    dict(absent_score=0.5, reduction="none"),
    dict(absent_score=0.25, reduction="sum"),
    dict(ignore_index=C + 2),
], ids=["default", "ignore-0", "ignore-3-none", "absent-none", "absent-sum", "ignore-out-of-range"])
def test_iou_matches_reference(kwargs):
    # three classes stay absent
    _drive(port.IoU(C, device="cpu", **kwargs), ref.IoU(C, **kwargs), "sparse")
    # the functional infers the classes from the data
    p, t = _inputs("sparse", 3)
    _assert_close(port_fn.iou(torch.from_numpy(p), torch.from_numpy(t), **kwargs),
                  ref_fn.iou(jnp.asarray(p), jnp.asarray(t), **kwargs))


@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
@pytest.mark.parametrize("kind", ["probs", "labels"])
def test_cohen_kappa_matches_reference(kind, weights):
    _drive(port.CohenKappa(C, weights=weights, device="cpu"), ref.CohenKappa(C, weights=weights), kind)
    p, t = _inputs(kind, 4)
    _assert_close(port_fn.cohen_kappa(torch.from_numpy(p), torch.from_numpy(t), C, weights=weights),
                  ref_fn.cohen_kappa(jnp.asarray(p), jnp.asarray(t), C, weights=weights))


def test_cohen_kappa_weights_checks_match_reference():
    with pytest.raises(ValueError):
        ref.CohenKappa(C, weights="cubic")
    with pytest.raises(ValueError):
        port.CohenKappa(C, weights="cubic", device="cpu")
    # "none" passes the constructor but not compute, in both
    m_port, m_ref = port.CohenKappa(C, weights="none", device="cpu"), ref.CohenKappa(C, weights="none")
    p, t = _inputs("labels", 0)
    m_port.update(torch.from_numpy(p), torch.from_numpy(t))
    m_ref.update(jnp.asarray(p), jnp.asarray(t))
    with pytest.raises(ValueError):
        m_ref.compute()
    with pytest.raises(ValueError):
        m_port.compute()


@pytest.mark.parametrize("kind", ["probs", "labels"])
def test_matthews_corrcoef_matches_reference(kind):
    m_port, m_ref = port.MatthewsCorrcoef(C, device="cpu"), ref.MatthewsCorrcoef(C)
    _drive(m_port, m_ref, kind)
    assert m_port.confmat.dtype == torch.float32  # as the JAX package's state
    p, t = _inputs(kind, 5)
    _assert_close(port_fn.matthews_corrcoef(torch.from_numpy(p), torch.from_numpy(t), C),
                  ref_fn.matthews_corrcoef(jnp.asarray(p), jnp.asarray(t), C))


def test_matthews_corrcoef_is_nan_on_degenerate_marginals():
    zeros = np.zeros(N, dtype=np.int64)
    want = ref_fn.matthews_corrcoef(jnp.asarray(zeros), jnp.asarray(zeros), C)
    got = port_fn.matthews_corrcoef(torch.from_numpy(zeros), torch.from_numpy(zeros), C)
    assert np.isnan(_np(want)) and torch.isnan(got)
    m = port.MatthewsCorrcoef(C, device="cpu")
    m.update(torch.from_numpy(zeros), torch.from_numpy(zeros))
    assert torch.isnan(m.compute())


@pytest.mark.parametrize("kwargs", [
    {},
    dict(bg=True),
    dict(bg=True, reduction="none"),
    dict(nan_score=0.5, no_fg_score=0.25, reduction="sum"),
], ids=["default", "bg", "bg-none", "scores-sum"])
@pytest.mark.parametrize("kind", ["probs", "labels"])
def test_dice_score_matches_reference(kind, kwargs):
    rng = np.random.RandomState(6)
    # labels 0..5 of 10 classes: absent classes take the no-foreground score
    t = rng.randint(0, 6, (2, N))
    p = rng.rand(2, C, N).astype(np.float32) if kind == "probs" else rng.randint(0, 6, (2, N))
    if kind == "labels":
        # dice_score reads the classes off preds.shape[1]
        p = p[:, :C]
    _assert_close(port_fn.dice_score(torch.from_numpy(p), torch.from_numpy(t), **kwargs),
                  ref_fn.dice_score(jnp.asarray(p), jnp.asarray(t), **kwargs))


@pytest.mark.parametrize("values", [
    [0, 1, 2, 3, 3, 1, 0, 2],
    [0, 1, 5, 4, 9, 3, 3, 12],
    [-1, -4, -2, -3, -1, 0, 1, 2],
    [-9, -5, -4, -1, 3, 4, 7, 100],
], ids=["in-range", "out-of-range", "negative", "both"])
def test_bincount_matches_reference(values):
    got = _bincount(torch.tensor(values), 4)
    assert got.dtype == torch.int64
    _assert_close(got, ref_bincount(jnp.asarray(values), 4))


def test_bincount_drop_and_wrap_rule():
    assert _bincount(torch.tensor([0, 1, 5, -1, 9]), 4).tolist() == [1, 1, 0, 1]


def test_spill_case_matches_reference():
    # [8, 5] probabilities with num_classes=3 fail validation; both fall back
    # to five inferred classes, and target*3 + pred spills across rows
    rng = np.random.RandomState(0)
    preds = rng.rand(8, 5).astype(np.float32)
    target = rng.randint(0, 5, 8)
    want = ref_fn.confusion_matrix(jnp.asarray(preds), jnp.asarray(target), 3)
    got = port_fn.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target), 3)
    _assert_close(got, want)
    assert got.tolist() == [[0, 0, 0], [2, 0, 1], [1, 2, 0]]


def test_data_helpers_match_reference():
    from metrics_tpu.utils.data import get_num_classes as ref_get_num_classes, to_categorical as ref_to_categorical

    p, t = _inputs("probs", 7)
    _assert_close(to_categorical(torch.from_numpy(p)), ref_to_categorical(jnp.asarray(p)))
    lp, lt = _inputs("labels", 7)
    assert get_num_classes(torch.from_numpy(lp), torch.from_numpy(lt)) == ref_get_num_classes(
        jnp.asarray(lp), jnp.asarray(lt))
    with pytest.warns(RuntimeWarning, match="different from predicted"):
        assert get_num_classes(torch.from_numpy(lp), torch.from_numpy(lt), num_classes=C + 5) == C + 5
