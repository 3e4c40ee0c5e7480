"""Accuracy, StatScores and the flagship collection of the port against the JAX
package, on the same numpy inputs.

Counts compare exactly by value (the JAX package's are int32, the port's
int64). Float values compare at atol=1e-6: both reduce in float32, in another
order.
"""
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu_torch.utils.convert import state_dict_from_reference
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, StateDictMismatchError, StateSchemaError

ATOL = 1e-6
N, C, BATCHES = 256, 10, 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def _assert_states_equal(m_port, m_ref):
    for name in m_ref._defaults:
        got, want = m_port._state[name], m_ref._state[name]
        if isinstance(want, list):
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
        else:
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)


def _multiclass_batches(seed=0, n=N, c=C):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n, c).astype(np.float32), rng.randint(0, c, n)) for _ in range(BATCHES)]


def _binary_batches(seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.rand(N).astype(np.float32), rng.randint(0, 2, N)) for _ in range(BATCHES)]


def _multilabel_batches(seed=2, c=5):
    rng = np.random.RandomState(seed)
    return [(rng.rand(N, c).astype(np.float32), rng.randint(0, 2, (N, c))) for _ in range(BATCHES)]


def _drive(m_port, m_ref, batches, forward=True):
    """Feed the same batches to both; with ``forward`` compare each batch value."""
    for p, t in batches:
        if forward:
            _assert_close(m_port(torch.from_numpy(p), torch.from_numpy(t)), m_ref(jnp.asarray(p), jnp.asarray(t)))
        else:
            m_port.update(torch.from_numpy(p), torch.from_numpy(t))
            m_ref.update(jnp.asarray(p), jnp.asarray(t))


CASES = [
    ("Accuracy", dict(num_classes=C), _multiclass_batches),
    ("Accuracy", dict(num_classes=C, average="macro"), _multiclass_batches),
    ("Accuracy", dict(num_classes=C, average="weighted"), _multiclass_batches),
    ("Accuracy", dict(num_classes=C, average="none", ignore_index=3), _multiclass_batches),
    ("Accuracy", dict(num_classes=C, top_k=2), _multiclass_batches),
    ("Accuracy", dict(), _binary_batches),
    ("Accuracy", dict(), _multilabel_batches),
    ("Accuracy", dict(subset_accuracy=True), _multilabel_batches),
    ("StatScores", dict(reduce="micro", num_classes=C), _multiclass_batches),
    ("StatScores", dict(reduce="macro", num_classes=C), _multiclass_batches),
    ("StatScores", dict(reduce="micro", num_classes=C, ignore_index=0), _multiclass_batches),
    ("StatScores", dict(reduce="macro", num_classes=C, ignore_index=4), _multiclass_batches),
    ("StatScores", dict(reduce="samples", num_classes=C), _multiclass_batches),
    ("StatScores", dict(reduce="micro"), _binary_batches),
    ("StatScores", dict(reduce="macro", num_classes=5), _multilabel_batches),
]


@pytest.mark.parametrize("cls,kwargs,batches", CASES, ids=[f"{c}-{sorted(k.items())}-{b.__name__}" for c, k, b in CASES])
def test_metric_matches_reference(cls, kwargs, batches):
    m_port = getattr(port, cls)(device="cpu", **kwargs)
    m_ref = getattr(ref, cls)(**kwargs)
    _drive(m_port, m_ref, batches())
    _assert_states_equal(m_port, m_ref)
    _assert_close(m_port.compute(), m_ref.compute())


def _flagship(pkg, **kw):
    return pkg.MetricCollection({
        "acc": pkg.Accuracy(num_classes=C, **kw),
        "stats": pkg.StatScores(reduce="macro", num_classes=C, **kw),
    })


def test_flagship_collection_matches_reference():
    mc_port, mc_ref = _flagship(port, device="cpu"), _flagship(ref)
    for p, t in _multiclass_batches(seed=3):
        got = mc_port(torch.from_numpy(p), torch.from_numpy(t))
        want = mc_ref(jnp.asarray(p), jnp.asarray(t))
        assert sorted(got) == sorted(want) == ["acc", "stats"]
        for k in want:
            _assert_close(got[k], want[k])
    for k in ("acc", "stats"):
        _assert_states_equal(mc_port[k], mc_ref[k])
    got, want = mc_port.compute(), mc_ref.compute()
    for k in want:
        _assert_close(got[k], want[k])


def test_collection_prefix_postfix_and_kwarg_filtering():
    mc = port.MetricCollection([port.Accuracy(num_classes=C, device="cpu")], prefix="val_", postfix="_x")
    p, t = _multiclass_batches()[0]
    # a kwarg no member's update accepts is dropped, not passed on
    mc.update(preds=torch.from_numpy(p), target=torch.from_numpy(t), unused=1)
    assert list(mc.compute()) == ["val_Accuracy_x"]
    clone = mc.clone(prefix="test_")
    assert list(clone.keys(keep_base=False)) == ["test_Accuracy_x"]
    with pytest.raises(ValueError, match="two metrics both named"):
        port.MetricCollection([port.Accuracy(device="cpu"), port.Accuracy(device="cpu")])


def test_reset_returns_to_defaults():
    m = port.StatScores(reduce="macro", num_classes=C, device="cpu")
    batches = _multiclass_batches()
    _drive(m, ref.StatScores(reduce="macro", num_classes=C), batches[:1])
    fresh_value = m.compute().clone()
    m.update(*(torch.from_numpy(a) for a in batches[1]))
    m.reset()
    for name, v in m._state.items():
        assert torch.equal(v, m._defaults[name]), name
    m.update(*(torch.from_numpy(a) for a in batches[0]))
    assert torch.equal(m.compute(), fresh_value)


def test_compute_before_update_warns():
    m = port.Accuracy(num_classes=C, device="cpu")
    with pytest.warns(UserWarning, match="before the ``update``"):
        m.compute()


def test_compute_is_cached_until_the_next_update():
    m = port.Accuracy(num_classes=C, device="cpu")
    (p, t), (p2, t2) = _multiclass_batches()[:2]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    first = m.compute()
    assert m.compute() is first
    m.update(torch.from_numpy(p2), torch.from_numpy(t2))
    assert m.compute() is not first


def test_state_dict_from_reference_round_trip():
    mc_ref = _flagship(ref)
    for p, t in _multiclass_batches(seed=4):
        mc_ref.update(jnp.asarray(p), jnp.asarray(t))
    mc_ref.persistent(True)
    sd = state_dict_from_reference(mc_ref.state_dict(), device="cpu")
    assert sd["acc.tp"].dtype == torch.int64
    mc_port = _flagship(port, device="cpu")
    mc_port.load_state_dict(sd, strict=True)
    got, want = mc_port.compute(), mc_ref.compute()
    for k in want:
        _assert_close(got[k], want[k])
    # and back out through the port's own state_dict
    mc_port.persistent(True)
    again = mc_port.state_dict()
    assert sorted(again) == sorted(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


def test_load_state_dict_strict_raises_before_loading():
    m = port.StatScores(reduce="macro", num_classes=C, device="cpu")
    with pytest.raises(StateDictMismatchError, match="missing keys"):
        m.load_state_dict({"tp": torch.ones(C, dtype=torch.long), "bogus": torch.zeros(1)}, strict=True)
    assert torch.equal(m.tp, torch.zeros(C, dtype=torch.long))
    mc = _flagship(port, device="cpu")
    with pytest.raises(StateDictMismatchError):
        mc.load_state_dict({"acc.tp": torch.ones(C, dtype=torch.long)}, strict=True)


def test_merge_state_and_schema_check():
    (p, t), (p2, t2) = _multiclass_batches()[:2]
    a = port.StatScores(reduce="macro", num_classes=C, device="cpu")
    b = port.StatScores(reduce="macro", num_classes=C, device="cpu")
    both = port.StatScores(reduce="macro", num_classes=C, device="cpu")
    a.update(torch.from_numpy(p), torch.from_numpy(t))
    b.update(torch.from_numpy(p2), torch.from_numpy(t2))
    both.update(torch.from_numpy(p), torch.from_numpy(t))
    both.update(torch.from_numpy(p2), torch.from_numpy(t2))
    a.merge_state(b)
    assert torch.equal(a.compute(), both.compute())
    with pytest.raises(StateSchemaError, match="shape"):
        a.merge_state(port.StatScores(reduce="macro", num_classes=3, device="cpu"))


def test_pickle_and_clone_keep_state():
    m = port.Accuracy(num_classes=C, average="macro", device="cpu")
    p, t = _multiclass_batches()[0]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    value = m.compute()
    for copy in (pickle.loads(pickle.dumps(m)), m.clone()):
        assert torch.equal(copy.compute(), value)
        copy.update(torch.from_numpy(p), torch.from_numpy(t))
    assert torch.equal(m.compute(), value)


def test_sync_state_machine_raises():
    m = port.Accuracy(num_classes=C, device="cpu")
    p, t = _multiclass_batches()[0]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    # single process: sync is a no-op unless forced
    m.sync()
    assert not m._is_synced
    m.sync(dist_sync_fn=lambda state, reductions: state, distributed_available=lambda: True)
    assert m._is_synced
    with pytest.raises(MetricsTPUUserError, match="already been synced"):
        m.sync(dist_sync_fn=lambda state, reductions: state, distributed_available=lambda: True)
    with pytest.raises(MetricsTPUUserError, match="shouldn't be synced"):
        m.update(torch.from_numpy(p), torch.from_numpy(t))
    m.unsync()
    with pytest.raises(MetricsTPUUserError, match="already been un-synced"):
        m.unsync()
    with m.sync_context(dist_sync_fn=lambda s, r: s, distributed_available=lambda: True):
        assert m._is_synced
    assert not m._is_synced


def test_functional_matches_reference():
    from metrics_tpu.functional import accuracy as ref_accuracy, stat_scores as ref_stat_scores
    from metrics_tpu_torch.functional import accuracy, stat_scores

    p, t = _multiclass_batches()[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _assert_close(accuracy(torch.from_numpy(p), torch.from_numpy(t), average="macro", num_classes=C),
                      ref_accuracy(jnp.asarray(p), jnp.asarray(t), average="macro", num_classes=C))
        _assert_close(stat_scores(torch.from_numpy(p), torch.from_numpy(t), reduce="macro", num_classes=C),
                      ref_stat_scores(jnp.asarray(p), jnp.asarray(t), reduce="macro", num_classes=C))


@pytest.mark.parametrize("bad", [
    dict(preds=np.zeros((4, 3), np.float32), target=np.zeros((5,), np.int64)),
    dict(preds=np.zeros((4,), np.float32), target=np.full((4,), -1)),
    dict(preds=np.zeros((4,), np.float32), target=np.zeros((4,), np.float32)),
])
def test_invalid_inputs_raise_like_the_reference(bad):
    p, t = bad["preds"], bad["target"]
    with pytest.raises(ValueError):
        ref.Accuracy().update(jnp.asarray(p), jnp.asarray(t))
    with pytest.raises(ValueError):
        port.Accuracy(device="cpu").update(torch.from_numpy(p), torch.from_numpy(t))


def test_reduce_and_class_reduce_match_reference():
    from metrics_tpu.parallel.sync import class_reduce as ref_class_reduce, reduce as ref_reduce
    from metrics_tpu_torch.parallel.sync import class_reduce, reduce

    rng = np.random.RandomState(5)
    num, denom, weights = (rng.rand(C).astype(np.float32) for _ in range(3))
    for how in ("elementwise_mean", "sum", "none"):
        _assert_close(reduce(torch.from_numpy(num), how), ref_reduce(jnp.asarray(num), how))
    for how in ("micro", "macro", "weighted", "none"):
        _assert_close(
            class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.from_numpy(weights), how),
            ref_class_reduce(jnp.asarray(num), jnp.asarray(denom), jnp.asarray(weights), how),
        )


def test_module_moves_carry_defaults_and_states():
    m = port.BinnedAveragePrecision(num_classes=3, thresholds=11, device="cpu").double()
    assert m.TPs.dtype == m._defaults["TPs"].dtype == torch.float64
    assert m.thresholds.dtype == torch.float64
    m.float()
    p, t = _multiclass_batches(c=3)[0]
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    m.reset()
    assert m.TPs.dtype == torch.float32 and m.device == torch.device("cpu")
