"""CatBuffer and ``Metric.with_capacity`` in the port, case for case with the
eager cases of ``tests/bases/test_cat_buffer.py``, held against the JAX
package on the same numpy inputs.

The cases of that file that need ``jit`` (traced overflow, scans, donation,
the in-``jit`` collective) have no counterpart: the port never traces, and
its host sync of a CatBuffer is tested on two gloo ranks in
``test_torch_sync.py``. The overflow flag they latch reaches the port only
through a JAX snapshot; those cases here set it on the JAX side by hand.

Contents and counts compare exactly; AUROC and AP values at 1e-6 (the port
ranks in exact integers, the JAX package sums ranks in float32). The five
retrieval cases (at the end) hold RetrievalMAP and RetrievalCollection values
at 1e-6, the JAX test's own bound: float32 means of per-query float32 sums
of under 30 terms, over at most 23 queries, summed in another order
(log2(30) + log2(23) = 9.4 roundings of 2**-24 a side, 1.1e-6 at most, and
the values are below 1). List and capacity mode of the port agree bit for
bit where they see the same segments.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu_torch import CatBuffer
from metrics_tpu_torch.utils.convert import state_dict_from_reference
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

ATOL = 1e-6
NUM_BATCHES, BATCH_SIZE = 4, 16

rng = np.random.RandomState(7)
# scores on a 0.1 grid, so that tie groups span batches
_preds = np.round(rng.rand(NUM_BATCHES, BATCH_SIZE), 1).astype(np.float32)
_target = rng.randint(0, 2, (NUM_BATCHES, BATCH_SIZE))
CAPACITY = NUM_BATCHES * BATCH_SIZE


def _t(i, rows=None):
    sl = slice(None) if rows is None else rows
    return torch.from_numpy(_preds[i][sl]), torch.from_numpy(_target[i][sl])


def _j(i):
    return jnp.asarray(_preds[i]), jnp.asarray(_target[i])


def _ref_value(metric_cls, batches, **kw):
    m = metric_cls(**kw)
    for i in batches:
        m.update(*_j(i))
    return float(m.compute())


def _auroc(capacity=None):
    m = port.AUROC(device="cpu")
    return m if capacity is None else m.with_capacity(capacity)


# ---------------------------------------------------------------------------
# primitive behavior
# ---------------------------------------------------------------------------

def test_append_and_values():
    cb = CatBuffer(8)
    cb.append(torch.tensor([1.0, 2.0]))
    cb.append(torch.tensor([3.0]))
    assert len(cb) == 3
    np.testing.assert_array_equal(cb.values().numpy(), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(cb.mask().numpy(), [1, 1, 1, 0, 0, 0, 0, 0])


def test_scalar_append_promotes_to_row():
    cb = CatBuffer(4)
    cb.append(torch.tensor(5.0))
    cb.append(torch.tensor(6.0))
    np.testing.assert_array_equal(cb.values().numpy(), [5.0, 6.0])


def test_eager_overflow_raises():
    cb = CatBuffer(3)
    cb.append(torch.tensor([1.0, 2.0]))
    with pytest.raises(MetricsTPUUserError, match="overflow"):
        cb.append(torch.tensor([3.0, 4.0]))
    assert len(cb) == 2  # the refused batch wrote nothing
    with pytest.raises(MetricsTPUUserError, match="exceeds"):
        CatBuffer(3).append(torch.zeros(10))
    with pytest.raises(ValueError, match="capacity must be positive"):
        CatBuffer(0)


def test_merge_parity_and_overflow():
    a, b = CatBuffer(8), CatBuffer(8)
    a.append(torch.tensor([1.0, 2.0]))
    b.append(torch.tensor([3.0, 4.0, 5.0]))
    merged = a.merge(b)
    np.testing.assert_array_equal(merged.values().numpy(), [1, 2, 3, 4, 5])
    # the tail past the merged rows stays zero (has_nonfinite relies on it)
    np.testing.assert_array_equal(merged.buffer[5:].numpy(), [0, 0, 0])
    big_a, big_b = CatBuffer(4), CatBuffer(4)
    big_a.append(torch.zeros(3))
    big_b.append(torch.zeros(3))
    with pytest.raises(MetricsTPUUserError, match="overflow"):
        big_a.merge(big_b)


def test_multidim_rows():
    cb = CatBuffer(6)
    cb.append(torch.ones((2, 3)))
    cb.append(torch.zeros((1, 3)))
    assert tuple(cb.buffer.shape) == (6, 3)
    assert tuple(cb.values().shape) == (3, 3)


def test_append_shape_mismatch_is_loud():
    buf = CatBuffer(16)
    buf.append(torch.zeros((2, 3)))
    with pytest.raises(MetricsTPUUserError, match="item shape mismatch"):
        buf.append(torch.zeros((2, 4)))


def test_primitives_match_the_reference_buffer():
    """append, values, mask, merge, has_nonfinite and len against the JAX
    CatBuffer on the same rows."""
    rows = [np.array([1.5, np.nan], np.float32), np.array([-2.0, 0.25, 7.0], np.float32)]
    mine, theirs = CatBuffer(16), ref.CatBuffer(16)
    for r in rows:
        mine.append(torch.from_numpy(r))
        theirs.append(jnp.asarray(r))
    np.testing.assert_array_equal(mine.values().numpy(), np.asarray(theirs.values()))
    np.testing.assert_array_equal(mine.mask().numpy(), np.asarray(theirs.mask()))
    np.testing.assert_array_equal(mine.buffer.numpy(), np.asarray(theirs.buffer))
    assert bool(mine.has_nonfinite()) == bool(theirs.has_nonfinite()) is True
    assert len(mine) == len(theirs) == 5
    merged, ref_merged = mine.merge(mine), theirs.merge(theirs)
    np.testing.assert_array_equal(merged.buffer.numpy(), np.asarray(ref_merged.buffer))
    assert not bool(CatBuffer(2).append(torch.tensor([1, 2])).has_nonfinite())


def test_bool_buffer_dtype_survives_merge():
    a = CatBuffer(4).append(torch.tensor([True, False]))
    b = CatBuffer(4).append(torch.tensor([True]))
    merged = a.merge(b)
    assert merged.buffer.dtype == torch.bool
    np.testing.assert_array_equal(merged.values().numpy(), [True, False, True])


def test_reset_clears_overflow_flag():
    cb = CatBuffer(3, torch.zeros(3), count=3, overflowed=True)
    assert cb.overflowed
    fresh = cb.reset()
    assert not fresh.overflowed and len(fresh) == 0 and fresh.capacity == 3


def test_overflowed_buffer_is_loud():
    """The eager half of the JAX package's traced-overflow cases: a buffer
    carrying the flag raises on ``values()``, poisons a value to NaN with a
    warning, keeps the flag through merge, and a float carrier is used for
    an integer value."""
    cb = CatBuffer(4, torch.arange(4.0), count=4, overflowed=True)
    assert int(cb.mask().sum()) == 4
    with pytest.raises(MetricsTPUUserError, match="overflowed inside jit"):
        cb.values()
    with pytest.warns(UserWarning, match="CatBuffer overflowed"):
        assert torch.isnan(cb.poison(torch.tensor(0.5)))
    with pytest.warns(UserWarning, match="CatBuffer overflowed"):
        assert cb.poison(torch.tensor(3)).dtype == torch.float32
    assert CatBuffer(4).merge(cb).overflowed
    clean = CatBuffer(4).append(torch.tensor([1.0]))
    assert clean.poison(torch.tensor(7)).dtype == torch.int64


# ---------------------------------------------------------------------------
# no storage shared between live buffers (appends write in place)
# ---------------------------------------------------------------------------

def test_copy_is_independent_both_ways():
    cb = CatBuffer(8).append(torch.tensor([1.0, 2.0]))
    snap = cb.copy()
    snap.append(torch.tensor([9.0]))
    np.testing.assert_array_equal(cb.values().numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(cb.buffer[2:].numpy(), np.zeros(6))
    cb.append(torch.tensor([3.0, 4.0]))
    np.testing.assert_array_equal(snap.values().numpy(), [1.0, 2.0, 9.0])
    np.testing.assert_array_equal(cb.values().numpy(), [1.0, 2.0, 3.0, 4.0])
    merged = cb.merge(snap)
    cb.append(torch.tensor([5.0]))
    np.testing.assert_array_equal(merged.values().numpy(), [1.0, 2.0, 3.0, 4.0, 1.0, 2.0, 9.0])


def test_clone_pickle_state_dict_and_forward_do_not_alias():
    m = _auroc(CAPACITY)
    m.persistent(True)
    m.update(*_t(0))
    twin, thawed, sd = m.clone(), pickle.loads(pickle.dumps(m)), m.state_dict()
    first_value = m(*_t(1))  # forward: batch state, then in-place merge
    m.update(*_t(2))
    for other in (twin, thawed):
        assert len(other.preds) == BATCH_SIZE
        assert other.preds.buffer.data_ptr() != m.preds.buffer.data_ptr()
        np.testing.assert_array_equal(other.preds.buffer[BATCH_SIZE:].numpy(), 0)
    assert int(sd["preds"]["count"]) == BATCH_SIZE
    np.testing.assert_array_equal(sd["preds"]["buffer"][BATCH_SIZE:].numpy(), 0)
    np.testing.assert_array_equal(m._defaults["preds"].mask().numpy(), np.zeros(CAPACITY, bool))
    assert m._defaults["preds"].buffer is None
    # forward's batch value saw the batch alone
    assert torch.equal(first_value, _auroc()(*_t(1)))
    assert len(m.preds) == 3 * BATCH_SIZE


# ---------------------------------------------------------------------------
# metric integration
# ---------------------------------------------------------------------------

def test_with_capacity_parity_auroc():
    m_list, m_cb = _auroc(), _auroc(CAPACITY)
    for i in range(NUM_BATCHES):
        m_list.update(*_t(i))
        m_cb.update(*_t(i))
    want = _ref_value(ref.AUROC, range(NUM_BATCHES))
    np.testing.assert_allclose(float(m_list.compute()), want, atol=ATOL)
    np.testing.assert_allclose(float(m_cb.compute()), want, atol=ATOL)


def test_with_capacity_parity_average_precision():
    m = port.AveragePrecision(device="cpu").with_capacity(CAPACITY)
    for i in range(NUM_BATCHES):
        m.update(*_t(i))
    np.testing.assert_allclose(float(m.compute()), _ref_value(ref.AveragePrecision, range(NUM_BATCHES)), atol=ATOL)


def test_with_capacity_parity_pr_curve():
    m_list = port.PrecisionRecallCurve(device="cpu")
    m_cb = port.PrecisionRecallCurve(device="cpu").with_capacity(128)
    for i in range(NUM_BATCHES):
        m_list.update(*_t(i))
        m_cb.update(*_t(i))
    for a, b in zip(m_list.compute(), m_cb.compute()):
        assert torch.equal(a, b)


def test_with_capacity_after_update_raises():
    m = _auroc()
    m.update(*_t(0))
    with pytest.raises(MetricsTPUUserError, match="before any update"):
        m.with_capacity(128)


def test_with_capacity_resize_while_empty():
    m = _auroc(64).with_capacity(4096)
    assert m._defaults["preds"].capacity == 4096 and m.preds.capacity == 4096
    m.update(*_t(0))
    with pytest.raises(MetricsTPUUserError, match="cannot resize"):
        m.with_capacity(128)


def test_compute_without_update_raises():
    with pytest.raises(ValueError, match="No samples to concatenate"):
        _auroc(64).compute()


def test_metric_state_roundtrips():
    m = _auroc(128)
    for i in range(3):
        m.update(*_t(i))
    val = float(m.compute())
    assert float(pickle.loads(pickle.dumps(m)).compute()) == pytest.approx(val, abs=0)
    m.persistent(True)
    sd = m.state_dict()
    m3 = _auroc(128)
    m3.update(*_t(0))
    m3.reset()
    m3.load_state_dict(sd)
    assert float(m3.compute()) == pytest.approx(val, abs=0)
    # merge two halves == all data
    a, b = _auroc(CAPACITY), _auroc(CAPACITY)
    for i in range(NUM_BATCHES // 2):
        a.update(*_t(i))
    for i in range(NUM_BATCHES // 2, NUM_BATCHES):
        b.update(*_t(i))
    a.merge_state(b)
    np.testing.assert_allclose(float(a.compute()), _ref_value(ref.AUROC, range(NUM_BATCHES)), atol=ATOL)


def test_forward_batch_value_with_capacity():
    m, m_ref = _auroc(CAPACITY), ref.AUROC().with_capacity(CAPACITY)
    for i in range(NUM_BATCHES):
        np.testing.assert_allclose(float(m(*_t(i))), float(m_ref(*_j(i))), atol=ATOL)
    assert isinstance(m.preds, CatBuffer) and len(m.preds) == CAPACITY
    np.testing.assert_allclose(float(m.compute()), float(m_ref.compute()), atol=ATOL)


def test_checkpoint_across_state_modes():
    """A list-state checkpoint restores into a CatBuffer metric and back."""
    m_list = _auroc()
    for i in range(3):
        m_list.update(*_t(i))
    val = float(m_list.compute())
    m_list.persistent(True)
    sd = m_list.state_dict()

    m_cb = _auroc(256)
    m_cb.update(*_t(0))
    m_cb.reset()
    m_cb.load_state_dict(sd)
    assert isinstance(m_cb.preds, CatBuffer)
    assert float(m_cb.compute()) == pytest.approx(val, abs=ATOL)
    m_cb(*_t(3))  # forward keeps working after a cross-mode restore

    m_cb.persistent(True)
    sd_cb = m_cb.state_dict()
    m_back = _auroc()
    m_back.update(*_t(0))
    m_back.reset()
    m_back.load_state_dict(sd_cb)
    assert isinstance(m_back.preds, list)
    np.testing.assert_allclose(float(m_back.compute()), _ref_value(ref.AUROC, range(4)), atol=ATOL)


def test_load_state_dict_keeps_declared_capacity():
    m = _auroc(128)
    for i in range(3):
        m.update(*_t(i))
    m.persistent(True)
    sd = m.state_dict()
    big = _auroc(4096)
    big.load_state_dict(sd)
    assert big.preds.capacity == 4096
    big.update(*_t(3))  # must not overflow
    np.testing.assert_allclose(float(big.compute()), _ref_value(ref.AUROC, range(4)), atol=ATOL)


def test_merge_state_across_modes():
    a, b = _auroc(), _auroc(64)
    for i in range(2):
        a.update(*_t(i))
    for i in range(2, 4):
        b.update(*_t(i))
    a.merge_state(b)  # list mode absorbing a CatBuffer-mode metric
    np.testing.assert_allclose(float(a.compute()), _ref_value(ref.AUROC, range(4)), atol=ATOL)


def test_reset_restores_empty_capacity():
    m = _auroc(64)
    m.update(*_t(0))
    m.reset()
    assert isinstance(m.preds, CatBuffer) and len(m.preds) == 0 and m.preds.capacity == 64
    m.update(*_t(0))
    np.testing.assert_allclose(float(m.compute()), _ref_value(ref.AUROC, [0]), atol=ATOL)


def test_set_dtype_survives_reset_and_moves_only_floats():
    m = _auroc(32)
    m.update(*_t(0))
    m.set_dtype(torch.float16)
    assert m.preds.buffer.dtype == torch.float16
    assert m.target.buffer.dtype == torch.int64  # integer buffers keep their dtype
    m.reset()
    m.update(*_t(0))
    assert m.preds.buffer.dtype == torch.float16 and m.target.buffer.dtype == torch.int64
    m.double()
    assert m.preds.buffer.dtype == torch.float64
    m.to("cpu")
    assert m.preds.buffer.device.type == "cpu"


def test_overflowed_metric_list_merge_policy():
    """Merging a corrupt (overflowed) CatBuffer state INTO a list-state
    metric, which cannot carry the flag, fails with capacity-less advice."""
    m = _auroc(BATCH_SIZE)
    m.update(*_t(0))
    m.preds.overflowed = True
    assert isinstance(hash(m), int)
    m_list = _auroc()
    m_list.update(*_t(3))
    with pytest.raises(MetricsTPUUserError, match="cannot be merged into a list-state"):
        m_list.merge_states(m_list._state, m._state)


# ---------------------------------------------------------------------------
# JAX CatBuffer snapshots through utils/convert.py
# ---------------------------------------------------------------------------

def _ref_capacity_state_dict(overflowed=False):
    m = ref.AUROC().with_capacity(CAPACITY)
    for i in range(3):
        m.update(*_j(i))
    if overflowed:
        for name in ("preds", "target"):
            m._state[name].overflowed = jnp.asarray(True)
    m.persistent(True)
    return m, m.state_dict()


def test_reference_snapshot_loads_and_computes():
    m_ref, sd = _ref_capacity_state_dict()
    converted = state_dict_from_reference(sd, device="cpu")
    assert isinstance(converted["preds"], CatBuffer) and len(converted["preds"]) == 3 * BATCH_SIZE
    assert converted["target"].buffer.dtype == torch.int64
    for declared_capacity in (CAPACITY, None):  # into a CatBuffer metric, and into a list-state one
        m = _auroc(declared_capacity)
        m.update(*_t(0))
        m.reset()
        m.load_state_dict(converted)
        np.testing.assert_allclose(float(m.compute()), float(m_ref.compute()), atol=ATOL)
    # the list-state metric resumed the snapshot's valid rows, in order
    np.testing.assert_array_equal(m.preds[0].numpy(), _preds[:3].reshape(-1))


def test_overflowed_reference_snapshot_stays_loud():
    _, sd = _ref_capacity_state_dict(overflowed=True)
    converted = state_dict_from_reference(sd, device="cpu")
    assert converted["preds"].overflowed
    # the curve path reads the rows, and raises on them
    curve = _auroc(CAPACITY)
    curve.load_state_dict(converted)
    assert curve.preds.overflowed
    with pytest.raises(MetricsTPUUserError, match="overflowed inside jit"):
        curve.compute()
    # the ranking path (binary mode known from a warm-up update) poisons
    m = _auroc(CAPACITY)
    m.update(*_t(0))
    m.reset()
    m.load_state_dict(converted)
    with pytest.warns(UserWarning, match="CatBuffer overflowed"):
        assert torch.isnan(m.compute())
    with pytest.raises(MetricsTPUUserError, match="overflow flag of a loaded snapshot"):
        m.update(*_t(3))
    # a list-state metric has no flag to carry: the load fails
    with pytest.raises(MetricsTPUUserError, match="cannot be resumed into a list-state"):
        _auroc().load_state_dict(converted)
    # the port's own state_dict carries the flag, and old snapshots load clean
    m.persistent(True)
    own = m.state_dict()
    assert bool(own["preds"]["overflowed"])
    del own["preds"]["overflowed"], own["target"]["overflowed"]
    clean = _auroc(CAPACITY)
    clean.load_state_dict(own)
    assert not clean.preds.overflowed


# ---------------------------------------------------------------------------
# retrieval over CatBuffer states: the padded query grouping
# (``ops/segment.py`` ``valid`` mode) of ``num_queries`` + ``with_capacity``
# ---------------------------------------------------------------------------

RETRIEVAL_ATOL = 1e-6


def _retrieval_data(n=200, n_queries=23, seed=11):
    r = np.random.RandomState(seed)
    return r.rand(n).astype(np.float32), r.randint(0, 2, n), r.randint(0, n_queries, n)


def test_retrieval_map_with_capacity():
    idx = rng.randint(0, 10, (NUM_BATCHES, BATCH_SIZE))
    m = port.RetrievalMAP(device="cpu").with_capacity(NUM_BATCHES * BATCH_SIZE)
    m_list = port.RetrievalMAP(device="cpu")
    m_ref = ref.RetrievalMAP()
    for i in range(NUM_BATCHES):
        m.update(*_t(i), torch.from_numpy(idx[i]))
        m_list.update(*_t(i), torch.from_numpy(idx[i]))
        m_ref.update(*_j(i), jnp.asarray(idx[i]))
    assert isinstance(m.preds, CatBuffer)
    assert torch.equal(m.compute(), m_list.compute())  # the same rows, the same bits
    np.testing.assert_allclose(float(m.compute()), float(m_ref.compute()), atol=RETRIEVAL_ATOL)


def test_retrieval_catbuffer_padded_compute_matches_list_mode():
    """The padded grouping (no jit here: the same ``compute``) equals the
    list-state value, with a partially-filled buffer (padding rows must not
    leak into any query's ranking or the query mean); and the JAX package's
    padded value."""
    preds, target, idx = _retrieval_data()
    m_list = port.RetrievalMAP(device="cpu")
    m_list.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(idx))
    m = port.RetrievalMAP(num_queries=32, device="cpu").with_capacity(512)  # 200 of 512 filled
    m.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(idx))
    np.testing.assert_allclose(float(m.compute()), float(m_list.compute()), atol=RETRIEVAL_ATOL)
    m_ref = ref.RetrievalMAP(num_queries=32).with_capacity(512)
    m_ref.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(idx))
    np.testing.assert_allclose(float(m.compute()), float(m_ref.compute()), atol=RETRIEVAL_ATOL)


def test_retrieval_catbuffer_sync_straddling_queries(monkeypatch):
    """Query groups straddling rank boundaries (four ranks on threads): only
    the post-gather global grouping merges them; the value equals the
    single-process oracle."""
    from tests.helpers.torch_world import TorchLockstepWorld

    world_size, per_rank = 4, 16
    preds, _, _ = _retrieval_data(world_size * per_rank)
    gpos = np.arange(world_size * per_rank)
    target, idx = (gpos % 3 == 0).astype(np.int64), gpos // 5
    world = TorchLockstepWorld(world_size).install(monkeypatch)

    def body(rank):
        m = port.RetrievalMAP(num_queries=world_size * per_rank // 5 + 1, device="cpu").with_capacity(per_rank)
        rows = slice(rank * per_rank, (rank + 1) * per_rank)
        m.update(torch.from_numpy(preds[rows]), torch.from_numpy(target[rows]), torch.from_numpy(idx[rows]))
        return float(m.compute())

    got = world.run(body)
    oracle = ref.RetrievalMAP()
    oracle.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(idx))
    for value in got:
        np.testing.assert_allclose(value, float(oracle.compute()), atol=RETRIEVAL_ATOL)


def test_retrieval_catbuffer_overflow_poisons_map():
    """The overflow flag reaches the port through a JAX snapshot whose
    buffer overflowed inside jit (set on the JAX side by hand, as in the
    cases above): the padded compute warns and returns NaN, as the JAX
    package's does."""
    p, t, i = _retrieval_data()
    m_ref = ref.RetrievalMAP(num_queries=32).with_capacity(512)
    m_ref.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(i))
    for name in ("indexes", "preds", "target"):
        m_ref._state[name].overflowed = jnp.asarray(True)
    m_ref.persistent(True)
    converted = state_dict_from_reference(m_ref.state_dict(), device="cpu")
    m = port.RetrievalMAP(num_queries=32, device="cpu").with_capacity(512)
    m.load_state_dict(converted)
    assert m.preds.overflowed
    with pytest.warns(UserWarning, match="CatBuffer overflowed"):
        assert torch.isnan(m.compute())
    with pytest.warns(UserWarning, match="CatBuffer overflowed"):
        assert np.isnan(float(m_ref.compute()))


def test_retrieval_collection_catbuffer_compute():
    preds, target, idx = _retrieval_data()

    def members(pkg, **kw):
        return {"map": pkg.RetrievalMAP(**kw), "mrr": pkg.RetrievalMRR(**kw), "p": pkg.RetrievalPrecision(k=3, **kw)}

    # the port's padded collection against its eager list-state twin, and
    # against the JAX package's padded collection (the shapes of the case
    # above, so the JAX side compiles little)
    eager = port.RetrievalCollection(members(port, device="cpu"), device="cpu")
    eager.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(idx))
    expected = eager.compute()
    coll = port.RetrievalCollection(members(port, device="cpu"), num_queries=32, device="cpu").with_capacity(512)
    coll.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(idx))
    got = coll.compute()
    coll_ref = ref.RetrievalCollection(members(ref), num_queries=32).with_capacity(512)
    coll_ref.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(idx))
    want = coll_ref.compute()
    for k, v in expected.items():
        np.testing.assert_allclose(float(got[k]), float(v), atol=RETRIEVAL_ATOL, err_msg=k)
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=RETRIEVAL_ATOL, err_msg=k)
