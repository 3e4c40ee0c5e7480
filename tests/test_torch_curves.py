"""The cat-state curve family in the port against the JAX package, on the same
numpy inputs: the ranking ops of ``ops/ranking.py``, then ROC, the
precision–recall curve, AUC, AUROC (with ``max_fpr``) and average
precision, functional and module, binary, multiclass and multilabel, with
list states and with ``with_capacity``.

One data set serves every case. Each score column is a permutation of the
same values (16 levels, 4 rows each, so tie groups of 4), so every class's
curve has the same number of points: the JAX side compiles each op of a
curve once per distinct length, and this keeps the lengths few. A second
copy has one NaN score per column.

NaN scores are where the two AUROC paths of the JAX package part: ranking
sorts a NaN above every score, the curve below. The port keeps both, so
with NaN scores each path is held against its own JAX counterpart, and the
two modes against each other only on data without NaN.

Curve points compare at 1e-6 (both sides count in float32 and divide the
same integers); ranking values at 1e-6 (the port ranks in exact integers,
the JAX package sums ranks in float32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional as ref_fn
import metrics_tpu_torch as port
import metrics_tpu_torch.functional as port_fn
from metrics_tpu.ops import ranking as ref_ranking
from metrics_tpu_torch.ops import ranking

ATOL = 1e-6
N, C = 64, 5

_rng = np.random.RandomState(11)
_levels = np.repeat(np.arange(16, dtype=np.float32) / 16, 4)
SCORES = np.stack([_rng.permutation(_levels) for _ in range(C)], axis=1).astype(np.float32)
WITH_NAN = SCORES.copy()
WITH_NAN[np.arange(C) * 7 + 3, np.arange(C)] = np.nan  # one NaN score per column, in different rows
BINARY, BINARY_NAN = SCORES[:, 0], WITH_NAN[:, 0]
BINARY_TARGET = _rng.randint(0, 2, N)
LABELS = np.concatenate([np.arange(C), _rng.randint(0, C, N - C)])  # every class observed
MULTILABEL = _rng.randint(0, 2, (N, C))
MASK = _rng.rand(N) > 0.25
WEIGHTS = _rng.rand(N).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
        return
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True)


def _both(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays], [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# ranking ops
# ---------------------------------------------------------------------------

AVERAGES = ("macro", "weighted", None)


@functools.lru_cache(maxsize=None)
def _ranking_reference():
    """Every value of the JAX ranking ops these tests compare with, from one
    jitted program: the ops are static-shape, and one compile costs a
    fraction of the op-by-op compiles of their eager calls."""

    def all_values(binary, target, scores, labels, multilabel, mask):
        out = {}
        for masked, m in (("masked", mask), ("unmasked", None)):
            valid = jnp.ones(N, bool) if m is None else m
            out["ranks", masked] = ref_ranking.tie_averaged_ranks(binary, valid)
            for name, t in (("binary", target), ("degenerate", jnp.zeros_like(target))):
                out[name, "auroc", masked] = ref_ranking.masked_binary_auroc(binary, t, m)
                out[name, "ap", masked] = ref_ranking.masked_binary_average_precision(binary, t, m)
        for average in AVERAGES:
            out["multiclass", "auroc", str(average)] = ref_ranking.masked_multiclass_auroc(scores, labels, mask, average)
            out["multiclass", "ap", str(average)] = ref_ranking.masked_multiclass_average_precision(
                scores, labels, mask, average)
            out["multilabel", "auroc", str(average)] = ref_ranking.masked_multilabel_auroc(scores, multilabel, mask, average)
        return out

    _, args = _both(BINARY_NAN, BINARY_TARGET, WITH_NAN, LABELS, MULTILABEL, MASK)
    return jax.device_get(jax.jit(all_values)(*args))


@pytest.mark.parametrize("masked", [False, True])
def test_tie_averaged_ranks_match_reference(masked):
    valid = MASK if masked else np.ones(N, bool)
    (v, m), _ = _both(BINARY_NAN, valid)
    want = _ranking_reference()["ranks", "masked" if masked else "unmasked"]
    np.testing.assert_array_equal(_np(ranking.tie_averaged_ranks(v, m))[valid], want[valid])


@pytest.mark.parametrize("masked", [False, True])
def test_masked_binary_ops_match_reference(masked):
    (p, t, m), _ = _both(BINARY_NAN, BINARY_TARGET, MASK)
    m = m if masked else None
    ref_values = _ranking_reference()
    key = "masked" if masked else "unmasked"
    # degenerate: no positive among the valid rows -> 0.5 and NaN, as in JAX
    for name, target in (("binary", t), ("degenerate", torch.zeros_like(t))):
        _assert_close(ranking.masked_binary_auroc(p, target, m), ref_values[name, "auroc", key])
        _assert_close(ranking.masked_binary_average_precision(p, target, m), ref_values[name, "ap", key])


@pytest.mark.parametrize("average", AVERAGES)
def test_masked_multiclass_ops_match_reference(average):
    (p, t, m), _ = _both(WITH_NAN, LABELS, MASK)
    _assert_close(ranking.masked_multiclass_auroc(p, t, m, average), _ranking_reference()["multiclass", "auroc", str(average)])
    _assert_close(ranking.masked_multiclass_average_precision(p, t, m, average),
                  _ranking_reference()["multiclass", "ap", str(average)])


# "micro" (one flattened binary problem) is held against the JAX curve value
# by the module cases below
@pytest.mark.parametrize("average", AVERAGES)
def test_masked_multilabel_auroc_matches_reference(average):
    (p, t, m), _ = _both(WITH_NAN, MULTILABEL, MASK)
    _assert_close(ranking.masked_multilabel_auroc(p, t, m, average), _ranking_reference()["multilabel", "auroc", str(average)])


def test_masked_ops_equal_unmasked_ops_on_the_valid_rows():
    """A mask gives the value of the valid rows alone (what the modules pass)."""
    p, t, m = torch.from_numpy(WITH_NAN), torch.from_numpy(LABELS), torch.from_numpy(MASK)
    for fn in (ranking.masked_multiclass_auroc, ranking.masked_multiclass_average_precision):
        np.testing.assert_array_equal(_np(fn(p, t, m, None)), _np(fn(p[m], t[m], None, None)))


# ---------------------------------------------------------------------------
# functional curves
# ---------------------------------------------------------------------------

def test_binary_clf_curve_sorts_nan_last_like_argsort():
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve

    preds = torch.tensor([0.3, float("nan"), 0.7, 0.3, 0.9])
    assert torch.sort(-preds, stable=True).indices.tolist() == _np(jnp.argsort(-jnp.asarray(_np(preds)))).tolist()
    fps, tps, thr = _binary_clf_curve(preds, torch.tensor([1, 0, 1, 0, 1]))
    assert thr[:3].tolist() == pytest.approx([0.9, 0.7, 0.3]) and torch.isnan(thr[-1])
    assert tps.tolist() == [1.0, 2.0, 3.0, 3.0] and fps.tolist() == [0.0, 0.0, 1.0, 2.0]


@pytest.mark.parametrize("fn", ["roc", "precision_recall_curve"])
@pytest.mark.parametrize("case", ["binary", "weighted", "multiclass", "multilabel"])
def test_curve_functions_match_reference(fn, case):
    kw = {}
    if case in ("binary", "weighted"):
        (p, t), (jp, jt) = _both(BINARY_NAN, BINARY_TARGET)
        kw["pos_label"] = 1
        if case == "weighted":
            kw["sample_weights"] = WEIGHTS
    else:
        (p, t), (jp, jt) = _both(SCORES, LABELS if case == "multiclass" else MULTILABEL)
        kw["num_classes"] = C
    _assert_close(getattr(port_fn, fn)(p, t, **kw), getattr(ref_fn, fn)(jp, jt, **kw))


def test_roc_raises_without_both_classes():
    (p,), _ = _both(BINARY)
    with pytest.raises(ValueError, match="No positive samples"):
        port_fn.roc(p, torch.zeros(N, dtype=torch.long), pos_label=1)
    with pytest.raises(ValueError, match="No negative samples"):
        port_fn.roc(p, torch.ones(N, dtype=torch.long), pos_label=1)


@pytest.mark.parametrize("case", ["increasing", "decreasing", "reorder"])
def test_auc_matches_reference(case):
    x = np.sort(SCORES[:, 1])
    y = SCORES[:, 2]
    if case == "decreasing":
        x = x[::-1].copy()
    if case == "reorder":
        x = SCORES[:, 1]
    (tx, ty), (jx, jy) = _both(x, y)
    _assert_close(port_fn.auc(tx, ty, reorder=case == "reorder"), ref_fn.auc(jx, jy, reorder=case == "reorder"))
    m, m_ref = port.AUC(reorder=case == "reorder", device="cpu"), ref.AUC(reorder=case == "reorder")
    for half in (slice(0, N // 2), slice(N // 2, N)):
        m.update(tx[half], ty[half])
        m_ref.update(jx[half], jy[half])
    _assert_close(m.compute(), m_ref.compute())


def test_auc_rejects_non_monotonic_x():
    with pytest.raises(ValueError, match="neither increasing or decreasing"):
        port_fn.auc(torch.from_numpy(SCORES[:, 1]), torch.from_numpy(SCORES[:, 2]))
    with pytest.raises(ValueError, match="same number of elements"):
        port_fn.auc(torch.zeros(3), torch.zeros(4))


@pytest.mark.parametrize("max_fpr", [None, 0.3, 0.55, 1.0])
def test_binary_auroc_matches_reference(max_fpr):
    (p, t), (jp, jt) = _both(BINARY_NAN, BINARY_TARGET)
    _assert_close(port_fn.auroc(p, t, pos_label=1, max_fpr=max_fpr), ref_fn.auroc(jp, jt, pos_label=1, max_fpr=max_fpr))


@pytest.mark.parametrize("case,average", [
    ("multiclass", "macro"), ("multiclass", "weighted"), ("multiclass", None),
    ("multilabel", "macro"), ("multilabel", "weighted"), ("multilabel", "micro"), ("multilabel", None),
])
def test_multi_auroc_and_average_precision_match_reference(case, average):
    (p, t), (jp, jt) = _both(SCORES, LABELS if case == "multiclass" else MULTILABEL)
    _assert_close(port_fn.auroc(p, t, num_classes=C, average=average),
                  ref_fn.auroc(jp, jt, num_classes=C, average=average))
    if not (case == "multiclass" and average == "micro"):
        _assert_close(port_fn.average_precision(p, t, num_classes=C, average=average),
                      ref_fn.average_precision(jp, jt, num_classes=C, average=average))


def test_weighted_auroc_drops_an_unobserved_class():
    labels = np.where(LABELS == 3, 1, LABELS)
    (p, t), (jp, jt) = _both(SCORES, labels)
    with pytest.warns(UserWarning, match="Class 3 had 0 observations"):
        got = port_fn.auroc(p, t, num_classes=C, average="weighted")
    _assert_close(got, ref_fn.auroc(jp, jt, num_classes=C, average="weighted"))


def test_binary_average_precision_matches_reference():
    (p, t), (jp, jt) = _both(BINARY_NAN, BINARY_TARGET)
    _assert_close(port_fn.average_precision(p, t, pos_label=1), ref_fn.average_precision(jp, jt, pos_label=1))


def test_auroc_argument_errors():
    (p, t), _ = _both(SCORES, LABELS)
    with pytest.raises(ValueError, match="did not provide `num_classes`"):
        port_fn.auroc(p, t)
    with pytest.raises(ValueError, match="Partial AUC computation not available"):
        port_fn.auroc(p, t, num_classes=C, max_fpr=0.5)
    with pytest.raises(ValueError, match="`max_fpr` should be a float"):
        port.AUROC(max_fpr=2.0, device="cpu")
    with pytest.raises(ValueError, match="`average` expected"):
        port.AUROC(average="samples", device="cpu")
    with pytest.raises(ValueError, match="Cannot use `micro` average with multi-class input"):
        port_fn.average_precision(p, t, num_classes=C, average="micro")


# ---------------------------------------------------------------------------
# modules, list states and with_capacity
# ---------------------------------------------------------------------------

MODULE_CASES = [
    ("AUROC", "binary", {}),
    ("AUROC", "binary", {"max_fpr": 0.3}),
    ("AUROC", "multiclass", {"num_classes": C, "average": "macro"}),
    ("AUROC", "multiclass", {"num_classes": C, "average": None}),
    ("AUROC", "multilabel", {"num_classes": C, "average": "weighted"}),
    ("AUROC", "multilabel", {"num_classes": C, "average": "micro"}),
    ("AveragePrecision", "binary", {}),
    ("AveragePrecision", "multiclass", {"num_classes": C, "average": "weighted"}),
    ("AveragePrecision", "multiclass", {"num_classes": C, "average": None}),
    ("AveragePrecision", "multilabel", {"num_classes": C, "average": "micro"}),
    ("ROC", "binary", {"pos_label": 1}),
    ("ROC", "multiclass", {"num_classes": C}),
    ("PrecisionRecallCurve", "binary", {"pos_label": 1}),
    ("PrecisionRecallCurve", "multilabel", {"num_classes": C}),
]


def _module_inputs(case):
    if case == "binary":
        return BINARY, BINARY_TARGET
    return SCORES, LABELS if case == "multiclass" else MULTILABEL


@pytest.mark.parametrize("name,case,kw", MODULE_CASES, ids=lambda v: str(v))
def test_module_matches_reference_in_both_modes(name, case, kw):
    """Three uneven batches; the list-state module and the ``with_capacity``
    one (ranking where the mode allows) both match the JAX list-state
    module, and each other to 1e-6."""
    preds, target = _module_inputs(case)
    m_list = getattr(port, name)(device="cpu", **kw)
    m_cap = getattr(port, name)(device="cpu", **kw).with_capacity(N * C + 8)
    m_ref = getattr(ref, name)(**kw)
    for rows in (slice(0, 20), slice(20, 21), slice(21, N)):
        (p, t), (jp, jt) = _both(preds[rows], target[rows])
        m_list.update(p, t)
        m_cap.update(p, t)
        m_ref.update(jp, jt)
    assert isinstance(m_cap.preds, port.CatBuffer) and len(m_cap.preds) == sum(len(x) for x in m_list.preds)
    want = m_ref.compute()
    _assert_close(m_list.compute(), want)
    _assert_close(m_cap.compute(), want)


@pytest.mark.parametrize("name,key", [("AUROC", "auroc"), ("AveragePrecision", "ap")])
def test_nan_score_in_both_modes(name, key):
    """With a NaN score each mode matches its JAX counterpart: for AUROC the
    ranking path counts the NaN above every score and the curve path below
    it, in both packages; for average precision both put it last. The JAX
    module's capacity path runs the masked op over its full buffer, which
    is the reference value of the ranking tests above."""
    m_list, m_cap = getattr(port, name)(device="cpu"), getattr(port, name)(device="cpu").with_capacity(N)
    r_list = getattr(ref, name)()
    for rows in (slice(0, 40), slice(40, N)):
        (p, t), (jp, jt) = _both(BINARY_NAN[rows], BINARY_TARGET[rows])
        for m in (m_list, m_cap):
            m.update(p, t)
        r_list.update(jp, jt)
    _assert_close(m_list.compute(), r_list.compute())
    _assert_close(m_cap.compute(), _ranking_reference()["binary", key, "unmasked"])
    if name == "AveragePrecision":
        _assert_close(m_cap.compute(), m_list.compute())
