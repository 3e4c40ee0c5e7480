"""The pure state API and the gradient contract, against the JAX package.

Port twins of the pure cases of ``tests/bases/test_metric.py``, of
``tests/bases/test_merge_properties.py``, and of
``tests/bases/test_dtype_and_grad.py::test_differentiable`` /
``::test_non_differentiable_zero_grad``:

- ``init_state`` / ``pure_update`` / ``pure_compute`` / ``pure_forward`` /
  ``merge_states`` of a metric and of a ``MetricCollection`` give the JAX
  package's values on the same inputs, and leave the instance's state and
  update count alone;
- merging agrees with plain accumulation and is associative, for one metric
  per state algebra (the JAX file's ROUGE case is a list state, as
  Spearman's here), each value held to the JAX package's over all chunks;
- the gradient of ``pure_compute(pure_update(init_state(), preds, target))``
  with respect to ``preds`` equals ``jax.grad`` of the JAX package's same
  pure path (float32 on both sides, sums in another order: rtol 1e-4, atol
  1e-6 on the gradient's scale), and is zero (or absent) for a metric
  declared not differentiable;
- ``forward``'s value requires grad exactly when the class declares
  ``is_differentiable=True`` (ROADMAP C.19), and the running states stay
  detached.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port

rng = np.random.RandomState(23)
N, C = 32, 5
_float_preds = rng.randn(N).astype(np.float32)
_float_target = rng.randn(N).astype(np.float32)
_pos_preds = np.abs(_float_preds) + 0.1
_pos_target = np.abs(_float_target) + 0.1
_prob_preds = rng.rand(N, C).astype(np.float32)
_class_target = rng.randint(0, C, (N,))
_bin_preds = rng.rand(N).astype(np.float32)
_bin_target = rng.randint(0, 2, (N,))
_2d_preds = rng.randn(N, 8).astype(np.float32)
_2d_target = rng.randn(N, 8).astype(np.float32)
_probdist = rng.rand(N, C).astype(np.float32) + 0.05
_probdist /= _probdist.sum(-1, keepdims=True)
_probdist2 = rng.rand(N, C).astype(np.float32) + 0.05
_probdist2 /= _probdist2.sum(-1, keepdims=True)

DIFFERENTIABLE = [
    ("mse", "MeanSquaredError", _float_preds, _float_target, {}),
    ("mae", "MeanAbsoluteError", _float_preds, _float_target, {}),
    ("msle", "MeanSquaredLogError", _pos_preds, _pos_target, {}),
    ("mape", "MeanAbsolutePercentageError", _pos_preds, _pos_target, {}),
    ("smape", "SymmetricMeanAbsolutePercentageError", _pos_preds, _pos_target, {}),
    ("r2", "R2Score", _float_preds, _float_target, {}),
    ("pearson", "PearsonCorrcoef", _float_preds, _float_target, {}),
    ("explained_variance", "ExplainedVariance", _float_preds, _float_target, {}),
    ("tweedie", "TweedieDevianceScore", _pos_preds, _pos_target, {}),
    ("cosine", "CosineSimilarity", _2d_preds, _2d_target, {}),
    ("snr", "SNR", _float_preds, _float_target, {}),
    ("si_snr", "SI_SNR", _float_preds, _float_target, {}),
    ("si_sdr", "SI_SDR", _float_preds, _float_target, {}),
    ("kl", "KLDivergence", _probdist, _probdist2, {}),
    ("hinge", "Hinge", _float_preds, _bin_target, {}),
]
NON_DIFFERENTIABLE = [
    ("accuracy", "Accuracy", _prob_preds, _class_target, {"num_classes": C}),
    ("auroc", "AUROC", _bin_preds, _bin_target, {}),
    ("spearman", "SpearmanCorrcoef", _float_preds, _float_target, {}),
    ("average_precision", "AveragePrecision", _bin_preds, _bin_target, {}),
]
GRAD_CASES = [c + (True,) for c in DIFFERENTIABLE] + [c + (False,) for c in NON_DIFFERENTIABLE]


def _jax_grad(cls, preds, target, args):
    m = getattr(ref, cls)(**args)
    t = jnp.asarray(target)
    if m._group_shared_attrs:
        # warm the eager input-mode latch, so the pure path traces statically
        m.update(jnp.asarray(preds), t)
        m.reset()

    def scalar(p):
        out = m.pure_compute(m.pure_update(m.init_state(), p, t))
        leaves = jax.tree_util.tree_leaves(out)
        return sum(jnp.sum(x) for x in leaves if jnp.issubdtype(x.dtype, jnp.floating))

    return np.asarray(jax.grad(scalar)(jnp.asarray(preds)))


def _port_grad(cls, preds, target, args):
    m = getattr(port, cls)(**args, device="cpu")
    x = torch.tensor(preds, requires_grad=True)
    out = m.pure_compute(m.pure_update(m.init_state(), x, torch.from_numpy(target)))
    leaves = [v for v in (out.values() if isinstance(out, dict) else out if isinstance(out, (tuple, list)) else [out])]
    total = sum(v.sum() for v in leaves if v.is_floating_point() and v.requires_grad)
    assert m._update_count == 0 and not m._update_called, "the pure path touched the instance"
    if not isinstance(total, torch.Tensor):
        return None  # no graph reaches preds: a zero gradient
    (grad,) = torch.autograd.grad(total, x, allow_unused=True)
    return None if grad is None else grad.numpy()


@pytest.mark.parametrize("name,cls,preds,target,args,differentiable", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_pure_path_gradient_matches_jax_grad(name, cls, preds, target, args, differentiable):
    assert getattr(port, cls).is_differentiable is differentiable is getattr(ref, cls).is_differentiable
    got, want = _port_grad(cls, preds, target, args), _jax_grad(cls, preds, target, args)
    if not differentiable:
        assert not np.any(want) and (got is None or not np.any(got)), name
        return
    assert got is not None and np.any(got != 0), f"{name}: no gradient reaches preds"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("name,cls,preds,target,args,differentiable", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_forward_requires_grad_is_the_declared_flag(name, cls, preds, target, args, differentiable):
    m = getattr(port, cls)(**args, device="cpu")
    x = torch.tensor(preds, requires_grad=True)
    out = m(x, torch.from_numpy(target))
    assert out.requires_grad is differentiable, name
    out2 = m(x, torch.from_numpy(target))  # the second step merges into the accumulation
    assert out2.requires_grad is differentiable
    for k, v in m._state.items():
        for leaf in v if isinstance(v, list) else [v]:
            assert not leaf.requires_grad, f"{name}: running state {k} keeps the graph"
    if differentiable:
        (grad,) = torch.autograd.grad(out.sum(), x)
        assert torch.isfinite(grad).all() and bool((grad != 0).any())


# ---------------------------------------------------------------------------
# the pure API (tests/bases/test_metric.py)
# ---------------------------------------------------------------------------


class _PortSum(port.Metric):
    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


class _RefSum(ref.Metric):
    def __init__(self):
        super().__init__()
        self.add_state("x", jnp.asarray(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


def test_pure_update_is_stateless():
    m = _PortSum()
    s = m.init_state()
    s = m.pure_update(s, torch.tensor(1.0))
    s = m.pure_update(s, torch.tensor(2.0))
    r = _RefSum()
    rs = r.pure_update(r.pure_update(r.init_state(), jnp.asarray(1.0)), jnp.asarray(2.0))
    assert float(m.pure_compute(s)) == float(r.pure_compute(rs)) == 3.0
    assert float(m.x) == 0.0 and m._update_count == 0 and not m._update_called
    assert m.state_names == r.state_names == ["x"]


def test_pure_forward_fused():
    m, r = _PortSum(), _RefSum()
    s, rs = m.init_state(), r.init_state()
    for value in (2.0, 3.0):
        s, v = m.pure_forward(s, torch.tensor(value))
        rs, rv = r.pure_forward(rs, jnp.asarray(value))
        assert float(v) == float(rv) == value
    assert float(m.pure_compute(s)) == float(r.pure_compute(rs)) == 5.0


def test_pure_sync_waits_for_item_9_3():
    """Item 9.3 landed: with no axis (and no ``process_group``) ``pure_sync``
    raises the JAX package's user error, and an axis that names no process
    group (the JAX package's mesh-axis string) is refused as one; the syncs
    themselves are held to the JAX package in ``test_torch_subgroup_sync.py``."""
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    m = _PortSum()
    mc = port.MetricCollection({"s": m})
    for call in (lambda: m.pure_sync(m.init_state()), lambda: mc.pure_sync(mc.init_state())):
        with pytest.raises(MetricsTPUUserError, match="mesh axis"):
            call()
    for call in (lambda: m.pure_forward(m.init_state(), torch.tensor(1.0), axis_name="dp"),
                 lambda: mc.pure_forward(mc.init_state(), torch.tensor(1.0), axis_name="dp")):
        with pytest.raises(MetricsTPUUserError, match="process group"):
            call()


@pytest.mark.parametrize("grouped", [True, False])
def test_collection_pure_api_matches_the_jax_package(grouped):
    def make(pkg):
        kw = {} if pkg is ref else {"device": "cpu"}
        k = dict(num_classes=C, average="macro", **kw)
        return pkg.MetricCollection({"prec": pkg.Precision(**k), "rec": pkg.Recall(**k),
                                     "acc": pkg.Accuracy(num_classes=C, **kw)}, compute_groups=grouped)

    mc, rc = make(port), make(ref)
    batches = [(rng.rand(N, C).astype(np.float32), rng.randint(0, C, (N,))) for _ in range(3)]
    s, rs = mc.init_state(), rc.init_state()
    assert sorted(s) == sorted(rs) and all(sorted(s[k]) == sorted(rs[k]) for k in s)
    halves = []
    for p, t in batches:
        s = mc.pure_update(s, torch.from_numpy(p), torch.from_numpy(t))
        rs = rc.pure_update(rs, jnp.asarray(p), jnp.asarray(t))
        halves.append(mc.pure_update(mc.init_state(), torch.from_numpy(p), torch.from_numpy(t)))
    got, want = mc.pure_compute(s), rc.pure_compute(rs)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)
    merged = mc.merge_states(mc.merge_states(halves[0], halves[1]), halves[2])
    for k, v in mc.pure_compute(merged).items():
        assert torch.equal(v, got[k]), k
    s2, values = mc.pure_forward(s, torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]))
    rs2, rvalues = rc.pure_forward(rs, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    for k in rvalues:
        np.testing.assert_allclose(values[k].numpy(), np.asarray(rvalues[k]), rtol=1e-6, err_msg=k)
    for k, v in mc.pure_compute(s2).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(rc.pure_compute(rs2)[k]), rtol=1e-6, err_msg=k)
    assert all(m._update_count == 0 for m in mc.values())


# ---------------------------------------------------------------------------
# merge properties (tests/bases/test_merge_properties.py)
# ---------------------------------------------------------------------------


def _chunks(n):
    out = []
    for _ in range(n):
        preds = rng.rand(64).astype(np.float32)
        target = rng.randint(0, 2, 64)
        target[0], target[1] = 0, 1
        out.append((preds, target))
    return out


MERGE_CASES = {
    "accuracy_sum": ("Accuracy", {}, None, _chunks(3)),
    "pearson_moments": ("PearsonCorrcoef", {}, None,
                        [(rng.rand(64).astype(np.float32), rng.rand(64).astype(np.float32)) for _ in range(3)]),
    "spearman_catlist": ("SpearmanCorrcoef", {}, None,
                         [(rng.rand(64).astype(np.float32), rng.rand(64).astype(np.float32)) for _ in range(3)]),
    "auroc_catbuffer": ("AUROC", {}, 1024, _chunks(3)),
    "psnr_minmax": ("PSNR", {}, None,
                    [((rng.rand(64) * 3).astype(np.float32), (rng.rand(64) * 3).astype(np.float32)) for _ in range(3)]),
}


def _metric_with(pkg, name, chunks):
    cls, args, capacity, _ = MERGE_CASES[name]
    m = getattr(pkg, cls)(**args, **({} if pkg is ref else {"device": "cpu"}))
    if capacity:
        m = m.with_capacity(capacity)
    conv = jnp.asarray if pkg is ref else torch.from_numpy
    for a in chunks:
        m.update(*(x if isinstance(x, list) else conv(x) for x in a))
    return m


def _values(v):
    if isinstance(v, dict):
        return np.array([float(v[k]) for k in sorted(v)])
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else jnp.asarray(v, jnp.float32), np.float64)


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_merge_agrees_with_accumulation_and_is_associative(name):
    chunks = MERGE_CASES[name][3]
    whole = _metric_with(port, name, chunks).compute()
    left = _metric_with(port, name, chunks[:1])
    for c in chunks[1:]:
        left.merge_state(_metric_with(port, name, [c]))
    tail = _metric_with(port, name, chunks[1:2])
    tail.merge_state(_metric_with(port, name, chunks[2:]))
    right = _metric_with(port, name, chunks[:1])
    right.merge_state(tail)
    reference = _metric_with(ref, name, chunks).compute()  # the JAX package fed all chunks
    for got in (left.compute(), right.compute()):
        np.testing.assert_allclose(_values(got), _values(whole), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_values(got), _values(reference), atol=1e-5, rtol=1e-5)
