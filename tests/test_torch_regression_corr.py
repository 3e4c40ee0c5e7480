"""Pearson's merge and sync, and Spearman's ranks, in the port against the
JAX package.

Pearson keeps six running moments with ``dist_reduce_fx=None``: a sync
gathers each to ``[W]`` and ``compute()`` folds them with the pairwise merge,
which is also the metric's ``merge_states`` (the empty-side select, with no
host read). Two ranks run on threads on both sides
(``tests/helpers/torch_world.py`` here, ``tests/helpers/fake_world.py`` for
the JAX package), and the JAX world's result is computed once per module.

Spearman's ranks must follow ``jnp.searchsorted``'s order: NaN above every
number and tied with NaN, -0.0 tied with 0.0 (trap C.4).

Tolerances. Ranks are exact (halves of integers). The moments are float32
sums of 32 terms per rank, added in another order on each side: 5
roundings of 2**-24 each, 3e-7 of a sum, so moments and values compare at
``RTOL = 2**-20`` plus ``ATOL = 1e-6`` (a correlation near 0 is a quotient
of such sums); counts exactly. A merge with an empty side selects the other
side's state unchanged, so that compares exactly with the port's own state
(and within the tolerance with the JAX package's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.parallel.sync as ref_sync
import metrics_tpu_torch as port
from metrics_tpu.functional.regression.spearman import _rank_data as ref_rank_data
from metrics_tpu_torch.functional.regression.spearman import _rank_data
from metrics_tpu_torch.parallel.bucketing import clear_sync_plan_cache
from metrics_tpu_torch.utils.convert import state_dict_from_reference
from tests.helpers.fake_world import LockstepWorld
from tests.helpers.torch_world import TorchLockstepWorld

ATOL, RTOL = 1e-6, 2.0 ** -20
WORLD, N, D = 2, 32, 3
MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")

_rng = np.random.RandomState(8)
X = _rng.normal(1.0, 2.0, (4, N)).astype(np.float32)
Y = (0.6 * X + _rng.normal(0.0, 1.5, (4, N))).astype(np.float32)
# a second family for the collection sync: positive depths, [N, D] outputs
DEPTH = _rng.uniform(0.5, 10.0, (4, N)).astype(np.float32)
DEPTH_PRED = (DEPTH * np.exp(_rng.normal(0.0, 0.1, (4, N)))).astype(np.float32)
MULTI = _rng.normal(0.0, 1.0, (4, N, D)).astype(np.float32)
MULTI_PRED = (MULTI + _rng.normal(0.0, 0.5, (4, N, D))).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want, atol=ATOL, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_pearson(batches):
    m = port.PearsonCorrcoef(device="cpu")
    for b in batches:
        m.update(_t(X[b]), _t(Y[b]))
    return m


def _ref_pearson(batches):
    m = ref.PearsonCorrcoef()
    for b in batches:
        m.update(jnp.asarray(X[b]), jnp.asarray(Y[b]))
    return m


# ---------------------------------------------------------------------------
# two-rank sync
# ---------------------------------------------------------------------------

def _rank_batches(rank):
    return [2 * rank, 2 * rank + 1]


@pytest.fixture(scope="module")
def reference_sync():
    """The JAX package's two-rank sync of Pearson (each rank two batches):
    every rank's gathered states and computed value."""
    world = LockstepWorld(WORLD)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "process_count", lambda: WORLD)
        mp.setattr(ref_sync, "_raw_process_allgather", world.allgather)
        mp.setenv("METRICS_TPU_SYNC_TIMEOUT_S", "0")

        def body(rank):
            m = _ref_pearson(_rank_batches(rank))
            m.sync()
            synced = {k: np.asarray(v) for k, v in m._state.items()}
            m.unsync()
            return synced, np.asarray(m.compute())

        return world.run(body)


@pytest.fixture
def world(monkeypatch):
    clear_sync_plan_cache()
    yield TorchLockstepWorld(WORLD).install(monkeypatch)
    clear_sync_plan_cache()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
def test_pearson_two_rank_sync_matches_reference(world, reference_sync, monkeypatch, fused):
    monkeypatch.setenv("METRICS_TPU_FUSED_SYNC", "1" if fused else "0")

    def body(rank):
        m = _port_pearson(_rank_batches(rank))
        m.sync()
        synced = {k: v.clone() for k, v in m._state.items()}
        m.unsync()
        local_shape = m.mean_x.shape
        return synced, m.compute(), local_shape

    for rank, (synced, value, local_shape) in enumerate(world.run(body)):
        want_synced, want_value = reference_sync[rank]
        assert local_shape == ()  # unsync restores the 0-d local states
        for k in MOMENTS:
            assert synced[k].shape == (WORLD,) and synced[k].dtype == torch.float32
            if k == "n_total":
                np.testing.assert_array_equal(_np(synced[k]), want_synced[k])
            else:
                _assert_close(synced[k], want_synced[k])
        _assert_close(value, want_value)
    # the fold over ranks agrees with one process over every batch
    _assert_close(world.run(lambda r: _port_pearson(_rank_batches(r)).compute())[0],
                  _ref_pearson(range(4)).compute())


def test_gathered_reference_states_carried_across(reference_sync):
    """A JAX-side synced ``[W]`` state, carried across as numpy, folds to the
    JAX value in the port."""
    want_synced, want_value = reference_sync[0]
    m = port.PearsonCorrcoef(device="cpu")
    m.load_state_dict(state_dict_from_reference(want_synced, device="cpu"), strict=True)
    assert m.mean_x.shape == (WORLD,)
    _assert_close(m.compute(), want_value)


def _regression_collection():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return port.MetricCollection({
            "mse": port.MeanSquaredError(device="cpu"),
            "rmse": port.MeanSquaredError(squared=False, device="cpu"),
            "tweedie": port.TweedieDevianceScore(power=2.0, device="cpu"),
            "pearson": port.PearsonCorrcoef(device="cpu"),
            "spearman": port.SpearmanCorrcoef(device="cpu"),
        })


def test_regression_collection_sync_equals_one_process(world):
    """Sum states sync to the one-process sums (counts exactly), Pearson's
    None states to ``[W]`` and fold, Spearman's cat states to all rows;
    the ExplainedVariance and R² ``[D]`` states of a second collection
    likewise. No member shares an update: regression declares no
    ``update_identity``."""

    def feed(mc, multi, batches):
        for b in batches:
            mc.update(_t(DEPTH_PRED[b]), _t(DEPTH[b]))
            multi.update(_t(MULTI_PRED[b]), _t(MULTI[b]))

    def multi_collection():
        return port.MetricCollection({
            "ev": port.ExplainedVariance(multioutput="raw_values", device="cpu"),
            "r2": port.R2Score(num_outputs=D, multioutput="raw_values", device="cpu"),
        })

    def body(rank):
        mc, multi = _regression_collection(), multi_collection()
        feed(mc, multi, _rank_batches(rank))
        assert mc.compute_group_keys == []
        return mc.compute(), multi.compute(), mc["mse"].total.clone()

    one, one_multi = _regression_collection(), multi_collection()
    world_results = world.run(body)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("metrics_tpu_torch.parallel.sync.distributed_available", lambda group=None: False)
        feed(one, one_multi, range(4))
        want, want_multi = one.compute(), one_multi.compute()
    for values, multi_values, local_total in world_results:
        assert int(local_total) == 2 * N  # the local count after unsync
        for k, v in want.items():
            _assert_close(values[k], v)
        for k, v in want_multi.items():
            assert multi_values[k].shape == (D,)
            _assert_close(multi_values[k], v, atol=4e-6)  # 1 - a / b, see test_torch_regression.py


# ---------------------------------------------------------------------------
# forward and merges
# ---------------------------------------------------------------------------

def test_pearson_forward_matches_reference():
    m_port, m_ref = port.PearsonCorrcoef(device="cpu"), ref.PearsonCorrcoef()
    for b in range(4):
        _assert_close(m_port(_t(X[b]), _t(Y[b])), m_ref(jnp.asarray(X[b]), jnp.asarray(Y[b])))
    for k in MOMENTS:
        _assert_close(getattr(m_port, k), np.asarray(getattr(m_ref, k)))
    _assert_close(m_port.compute(), m_ref.compute())


@pytest.mark.parametrize("sides", ["a_empty", "b_empty", "both_empty", "neither"])
def test_pearson_merge_states_matches_reference(sides):
    full_port, full_ref = _port_pearson([0, 1]), _ref_pearson([0, 1])
    other_port, other_ref = _port_pearson([2, 3]), _ref_pearson([2, 3])
    empty_port, empty_ref = port.PearsonCorrcoef(device="cpu"), ref.PearsonCorrcoef()
    a_port, a_ref = (empty_port, empty_ref) if sides in ("a_empty", "both_empty") else (full_port, full_ref)
    b_port, b_ref = (empty_port, empty_ref) if sides in ("b_empty", "both_empty") else (other_port, other_ref)
    got = full_port.merge_states(dict(a_port._state), dict(b_port._state))
    want = full_ref.merge_states(dict(a_ref._state), dict(b_ref._state))
    kept = {"a_empty": b_port, "b_empty": a_port, "both_empty": empty_port}.get(sides)
    for k in MOMENTS:
        _assert_close(got[k], np.asarray(want[k]))
        if kept is not None:
            # the select hands the non-empty side through unchanged
            assert torch.equal(got[k], getattr(kept, k)) and not torch.isnan(got[k]).any()
    if sides == "neither":
        full_port.merge_state(other_port)
        _assert_close(full_port.compute(), _ref_pearson(range(4)).compute())


def test_pearson_merge_states_reads_nothing_on_the_host():
    """The empty-side select traces into one graph: ``fullgraph=True``
    refuses a ``.item()`` or a Python branch on a tensor."""
    m = _port_pearson([0])
    merge = torch.compile(m.merge_states, backend="eager", fullgraph=True)
    for other in (port.PearsonCorrcoef(device="cpu"), _port_pearson([1])):
        got = merge(dict(m._state), dict(other._state))
        want = m.merge_states(dict(m._state), dict(other._state))
        for k in MOMENTS:
            assert torch.equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Spearman's ranks
# ---------------------------------------------------------------------------

NAN, INF = float("nan"), float("inf")
RANK_CASES = {
    "issue-nan": [0.3, 0.1, NAN, 0.9, 0.3, NAN],
    "nan-first": [NAN, 2.0, 1.0, NAN, NAN, 0.5],
    "all-nan": [NAN, NAN, NAN],
    "ties": [1.0, 2.0, 2.0, 3.0, 3.0, 3.0, 0.0, 2.0],
    "all-equal": [4.0, 4.0, 4.0, 4.0],
    "infinities": [INF, NAN, -INF, INF, 0.0, -1.0],
    "signed-zero": [0.0, -0.0, 1.0, -0.0, 0.0],
    "single": [7.0],
}


@pytest.mark.parametrize("case", RANK_CASES)
def test_rank_data_matches_reference(case):
    x = np.asarray(RANK_CASES[case], np.float32)
    got = _rank_data(torch.from_numpy(x))
    want = np.asarray(ref_rank_data(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), want)  # exact: halves of integers


def test_rank_data_of_integers_matches_reference():
    x = np.asarray([5, 3, 3, 9, 0, 3], np.int32)
    got = _rank_data(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), np.asarray(ref_rank_data(jnp.asarray(x))))


SPEARMAN_CASES = {
    "issue": ([0.3, 0.1, NAN, 0.9, 0.3, NAN], [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
    "nan-both": ([NAN, 2.0, 1.0, 0.5, 4.0, 3.0], [1.0, NAN, 2.0, 2.0, 5.0, 0.0]),
    "heavy-ties": ([1.0, 1.0, 2.0, 2.0, 2.0, 3.0], [0.2, 0.2, 0.2, 0.4, 0.4, 0.6]),
    "all-equal": ([1.0, 1.0, 1.0, 1.0, 1.0, 1.0], [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
}


@pytest.mark.parametrize("case", SPEARMAN_CASES)
def test_spearman_matches_reference(case):
    p, t = (np.asarray(v, np.float32) for v in SPEARMAN_CASES[case])
    got = port.functional.spearman_corrcoef(_t(p), _t(t))
    want = np.asarray(ref.functional.spearman_corrcoef(jnp.asarray(p), jnp.asarray(t)))
    _assert_close(got, want)
    if case == "issue":
        assert abs(float(got) - 0.5296407) <= 1e-6


def test_spearman_module_with_nan_in_capacity_mode_matches_reference():
    import warnings

    p, t = (np.asarray(v, np.float32) for v in SPEARMAN_CASES["nan-both"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m_port = port.SpearmanCorrcoef(device="cpu").with_capacity(12)
        m_ref = ref.SpearmanCorrcoef()
    for half in (slice(0, 3), slice(3, 6)):
        m_port.update(_t(p[half]), _t(t[half]))
        m_ref.update(jnp.asarray(p[half]), jnp.asarray(t[half]))
    _assert_close(m_port.compute(), m_ref.compute())
