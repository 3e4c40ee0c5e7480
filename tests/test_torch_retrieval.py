"""The retrieval family of the port against the JAX package.

Every functional and module, and ``RetrievalCollection``, on the same numpy
inputs as the JAX package: binary and graded (integer and float) targets,
tied and NaN scores, ``k`` None/1/4/10, the four empty-target actions, list
mode and the ``num_queries`` padded mode of CatBuffer states. Then the query
id rules of trap C.6 (int32 ids: the JAX package's wrap past 2**31 and its
reserved padding sentinel ``2**31 - 1``), the ``utils/data.py`` helpers and
a two-rank sync on the thread world with queries that straddle the ranks.

The JAX values are computed once per module (``reference``), over one data
shape, so the JAX side compiles each op once.

Tolerance. Ranks, group sizes, group starts, sorted rows and every error are
exact. A value is a float32 mean over at most ``QUERIES`` per-query scores
in [0, 1], each a quotient of float32 sums over at most ``MAX_ROWS`` rows of
its query; the two packages may add in other orders, each side off by
log2(MAX_ROWS) + log2(QUERIES) roundings of 2**-24, in opposite directions:
``ATOL`` below (1.1e-6). nDCG's log2 discounts may differ by one ulp (6e-8
relative), well inside it.
"""
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional as ref_f
import metrics_tpu_torch as port
import metrics_tpu_torch.functional as port_f
from metrics_tpu.ops import segment as ref_segment
from metrics_tpu.utils import data as ref_data
from metrics_tpu_torch.ops import segment as port_segment
from metrics_tpu_torch.utils import data as port_data
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs
from tests.helpers.torch_world import TorchLockstepWorld

QUERIES, ROWS = 16, 160
rng = np.random.RandomState(23)
# sparse query ids (as MS MARCO's), ten rows a query on average, uneven
IDS = np.sort(rng.choice(1_000_000, QUERIES, replace=False))
INDEXES = IDS[rng.randint(0, QUERIES, ROWS)].astype(np.int64)
# scores on a 0.1 grid (ties within queries) with three NaN scores
PREDS = np.round(rng.rand(ROWS), 1).astype(np.float32)
PREDS[[5, 50, 120]] = np.nan
BINARY = (rng.rand(ROWS) < 0.3).astype(np.int64)
BINARY[INDEXES == IDS[0]] = 0  # a query with no relevant row
BINARY[INDEXES == IDS[1]] = 1  # a query with no non-relevant row
GRADED = rng.randint(0, 4, ROWS).astype(np.int64)
GRADED_FLOAT = (rng.randint(0, 5, ROWS) / 2).astype(np.float32)
MAX_ROWS = int(np.bincount(np.searchsorted(IDS, INDEXES)).max())
# the functionals take one query at a time: eight queries of ten rows each
# (one shape, so the JAX side compiles each op once), the first with no
# relevant row and the second with no non-relevant one
FQUERIES = np.arange(80).reshape(8, 10)
ATOL = 2 * (math.log2(MAX_ROWS) + math.log2(QUERIES)) * 2.0**-24
# the padded mode's one shape (the JAX side compiles each op once): four
# empty groups above the data, a CatBuffer of 256 rows (96 unfilled)
BOUND, CAPACITY = QUERIES + 4, 256

DATA = {"binary": BINARY, "graded": GRADED, "graded_float": GRADED_FLOAT}
K_METRICS = ("RetrievalFallOut", "RetrievalNormalizedDCG", "RetrievalPrecision", "RetrievalRecall")
ACTIONS = ("neg", "pos", "skip", "error")


def _module_cases():
    cases = []
    for data in DATA:
        for action in ACTIONS:
            for name in ("RetrievalMAP", "RetrievalMRR"):
                cases.append((name, None, action, data))
            for name in K_METRICS:
                for k in (None, 1, 4, 10):
                    cases.append((name, k, action, data))
    return cases


MODULE_CASES = _module_cases()
PADDED_CASES = [(name, k, action) for name in ("RetrievalMAP", "RetrievalMRR") + K_METRICS
                for k, action in ((None, "neg"), (4, "skip"), (10, "pos"))
                if k is None or name in K_METRICS]


def _kwargs(name, k, action, **extra):
    kw = dict(empty_target_action=action, **extra)
    if k is not None:
        kw["k"] = k
    return kw


def _outcome(fn):
    """The value as numpy, or the exception class and message."""
    try:
        value = fn()
    except (ValueError, RuntimeError) as err:
        return type(err), str(err)
    if isinstance(value, dict):
        return {k: np.asarray(v) for k, v in value.items()}
    return np.asarray(value)


def _batches(target):
    """Three update batches of uneven size over the same rows."""
    return [slice(0, 50), slice(50, 110), slice(110, ROWS)], target


def _feed(m, target, arr):
    for sl in _batches(target)[0]:
        m.update(arr(PREDS[sl]), arr(target[sl]), indexes=arr(INDEXES[sl]))
    return m


def _ref_module(name, k, action, target, num_queries=None, capacity=None):
    m = getattr(ref, name)(**_kwargs(name, k, action, num_queries=num_queries))
    if capacity:
        m.with_capacity(capacity)
    return _feed(m, target, jnp.asarray).compute()


def _ref_collection(configs, target, num_queries=None, capacity=None):
    """{key: value} of JAX metrics ``configs`` ({key: (name, k, action)})
    scored off one RetrievalCollection."""
    names = {key: str(i) for i, key in enumerate(configs)}
    rc = ref.RetrievalCollection(
        {names[key]: getattr(ref, n)(**_kwargs(n, k, a)) for key, (n, k, a) in configs.items()},
        num_queries=num_queries)
    if capacity:
        rc.with_capacity(capacity)
    values = _feed(rc, target, jnp.asarray).compute()
    return {key: np.asarray(values[names[key]]) for key in configs}


def _port_module(name, k, action, target, num_queries=None, capacity=None):
    m = getattr(port, name)(**_kwargs(name, k, action, num_queries=num_queries), device="cpu")
    if capacity:
        m.with_capacity(capacity)
    return _feed(m, target, torch.from_numpy).compute()


@pytest.fixture(scope="module")
def reference():
    """Every JAX value these tests compare with, computed once."""
    out = {"module": {}, "padded": {}, "functional": {}}
    # the values come from JAX RetrievalCollections (one grouping for many
    # members, the same numbers as the members alone); a case that raises,
    # from its metric alone
    for data in DATA:
        for action in ACTIONS:
            cases = [(n, k) for n, k, a, d in MODULE_CASES if (a, d) == (action, data)]
            pooled = [(n, k) for n, k in cases
                      if action != "error" and (data == "binary" or n == "RetrievalNormalizedDCG")]
            values = _ref_collection({(n, k): (n, k, action) for n, k in pooled}, DATA[data]) if pooled else {}
            for n, k in cases:
                out["module"][n, k, action, data] = (
                    values[n, k] if (n, k) in values else _outcome(lambda: _ref_module(n, k, action, DATA[data])))
    for capacity in (None, CAPACITY):
        values = _ref_collection({c: c for c in PADDED_CASES}, BINARY, num_queries=BOUND, capacity=capacity)
        out["padded"].update({(*c, capacity): v for c, v in values.items()})
    for fname, k, data in FUNCTIONAL_CASES:
        fn = getattr(ref_f, fname)
        per_query = []
        for rows in FQUERIES:
            args = (jnp.asarray(PREDS[rows]), jnp.asarray(_functional_target(data)[rows]))
            per_query.append(_outcome(lambda: fn(*args) if k == "n/a" else fn(*args, k=k)))
        out["functional"][fname, k, data] = per_query
    return out


def _assert_same(got, want):
    if isinstance(want, tuple):  # an error: same class, same message
        assert got == want
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=0, err_msg=key)
    else:
        assert not isinstance(got, tuple), got
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,k,action,data", MODULE_CASES, ids=lambda v: str(v))
def test_module_matches_reference(reference, name, k, action, data):
    _assert_same(_outcome(lambda: _port_module(name, k, action, DATA[data])), reference["module"][name, k, action, data])


@pytest.mark.parametrize("name,k,action", PADDED_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("capacity", [None, CAPACITY])
def test_num_queries_padded_mode_matches_reference(reference, name, k, action, capacity):
    """``num_queries`` above the data (four empty padding groups), in list
    mode and with CatBuffer states 256 rows deep (96 unfilled)."""
    got = _outcome(lambda: _port_module(name, k, action, BINARY, num_queries=BOUND, capacity=capacity))
    _assert_same(got, reference["padded"][name, k, action, capacity])


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalFallOut"])
def test_padded_mode_equals_list_mode_bit_for_bit_at_the_exact_bound(name):
    """With ``num_queries`` equal to the number of queries and a full
    buffer, the two compute paths see the same segments: the same bits."""
    listed = _port_module(name, None, "neg", BINARY)
    padded = _port_module(name, None, "neg", BINARY, num_queries=QUERIES, capacity=ROWS)
    assert torch.equal(listed, padded)


def test_error_action_is_refused_with_num_queries():
    for pkg in (ref, port):
        kw = {} if pkg is ref else {"device": "cpu"}
        with pytest.raises(ValueError, match="incompatible with the jittable"):
            pkg.RetrievalMAP(empty_target_action="error", num_queries=4, **kw)
        with pytest.raises(ValueError, match="incompatible with the jittable"):
            pkg.RetrievalCollection({"m": pkg.RetrievalMAP(empty_target_action="error", **kw)}, num_queries=4, **kw)


@pytest.mark.parametrize("bad", [dict(empty_target_action="drop"), dict(k=0), dict(k=True), dict(k=2.0)])
def test_invalid_arguments_raise_as_the_reference(bad):
    def make(pkg, **kw):
        return lambda: pkg.RetrievalPrecision(**bad, **kw)

    assert _outcome(make(port, device="cpu")) == _outcome(make(ref))


def test_update_errors_match_the_reference():
    p, t, i = PREDS[:8], BINARY[:8], INDEXES[:8]
    cases = [
        (p, t, None),  # no indexes
        (p, t, i[:4]),  # shapes differ
        (p[:0], t[:0], i[:0]),  # empty
        (p, t, i.astype(np.float32)),  # float ids
        (t, t, i),  # integer scores
        (p, t + 1, i),  # non-binary target
    ]
    for preds, target, indexes in cases:
        def run(pkg, arr, **kw):
            m = pkg.RetrievalMAP(**kw)
            return lambda: m.update(arr(preds), arr(target), indexes=None if indexes is None else arr(indexes))

        got = _outcome(run(port, torch.from_numpy, device="cpu"))
        assert got == _outcome(run(ref, jnp.asarray))
        assert isinstance(got, tuple)


def test_compute_before_update_is_zero():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for capacity in (None, 16):
            m = port.RetrievalMRR(num_queries=4, device="cpu")
            if capacity:
                m.with_capacity(capacity)
            assert float(m.compute()) == 0.0


# ---------------------------------------------------------------------------
# RetrievalCollection
# ---------------------------------------------------------------------------


def _members(pkg, **kw):
    return {
        "mrr": pkg.RetrievalMRR(**kw),
        "map": pkg.RetrievalMAP(**kw),
        "ndcg10": pkg.RetrievalNormalizedDCG(k=10, **kw),
        "p4": pkg.RetrievalPrecision(k=4, **kw),
        "r10": pkg.RetrievalRecall(k=10, **kw),
        "fallout4": pkg.RetrievalFallOut(k=4, **kw),
        "map_skip": pkg.RetrievalMAP(empty_target_action="skip", **kw),
    }


@pytest.mark.parametrize("mode", ["list", "capacity"])
def test_collection_matches_reference_and_its_members(mode):
    num_queries, capacity = (None, None) if mode == "list" else (BOUND, CAPACITY)

    def run(pkg, arr, **kw):
        rc = pkg.RetrievalCollection(_members(pkg, **kw), num_queries=num_queries, **kw)
        if capacity:
            rc.with_capacity(capacity)
        return _feed(rc, BINARY, arr).compute()

    got = run(port, torch.from_numpy, device="cpu")
    _assert_same({k: v.numpy() for k, v in got.items()}, _outcome(lambda: run(ref, jnp.asarray)))
    # the collection is its members run alone, bit for bit
    for key, member in _members(port, device="cpu", num_queries=num_queries).items():
        if capacity:
            member.with_capacity(capacity)
        assert torch.equal(_feed(member, BINARY, torch.from_numpy).compute(), got[key]), key


def test_collection_graded_targets_take_the_strictest_rule():
    for pkg, arr, kw in ((port, torch.from_numpy, {"device": "cpu"}), (ref, jnp.asarray, {})):
        only_ndcg = pkg.RetrievalCollection({"ndcg": pkg.RetrievalNormalizedDCG(**kw)}, **kw)
        _feed(only_ndcg, GRADED, arr)
        mixed = pkg.RetrievalCollection([pkg.RetrievalNormalizedDCG(**kw), pkg.RetrievalMAP(**kw)], **kw)
        with pytest.raises(ValueError, match="binary"):
            _feed(mixed, GRADED, arr)
    with pytest.raises(ValueError, match="share a class name"):
        port.RetrievalCollection([port.RetrievalMAP(device="cpu"), port.RetrievalMAP(device="cpu")], device="cpu")
    with pytest.raises(ValueError, match="RetrievalMetric instances"):
        port.RetrievalCollection({"acc": port.Accuracy(device="cpu")}, device="cpu")


def test_collection_inherits_the_largest_member_bound_and_leaves_members_alone():
    members = {"a": port.RetrievalMAP(num_queries=8, device="cpu"), "b": port.RetrievalMRR(num_queries=20, device="cpu")}
    rc = port.RetrievalCollection(members, device="cpu")
    assert rc.num_queries == 20
    _feed(rc, BINARY, torch.from_numpy)
    assert all(len(m.preds) == 0 for m in members.values())
    assert "a=RetrievalMAP" in repr(rc)
    assert set(dict(rc.named_modules())) == {""}  # members are configuration, not submodules


# ---------------------------------------------------------------------------
# functionals
# ---------------------------------------------------------------------------

FUNCTIONAL_CASES = (
    [(f, "n/a", d) for f in ("retrieval_average_precision", "retrieval_reciprocal_rank") for d in ("binary",)]
    + [(f, k, "binary") for f in ("retrieval_fall_out", "retrieval_precision", "retrieval_recall",
                                  "retrieval_normalized_dcg") for k in (None, 1, 4, 10)]
    + [("retrieval_normalized_dcg", k, d) for k in (None, 4) for d in ("graded", "graded_float")]
    + [(f, "n/a", "graded") for f in ("retrieval_average_precision",)]
)


def _functional_target(data):
    target = DATA[data].copy()
    if data == "binary":
        target[FQUERIES[0]], target[FQUERIES[1]] = 0, 1
    return target


@pytest.mark.parametrize("fname,k,data", FUNCTIONAL_CASES, ids=lambda v: str(v))
def test_functional_matches_reference_on_every_query(reference, fname, k, data):
    fn = getattr(port_f, fname)
    for rows, want in zip(FQUERIES, reference["functional"][fname, k, data]):
        args = (torch.from_numpy(PREDS[rows]), torch.from_numpy(_functional_target(data)[rows]))
        _assert_same(_outcome(lambda: fn(*args) if k == "n/a" else fn(*args, k=k)), want)


def test_functional_input_errors_match_the_reference():
    cases = [
        (np.zeros(3, np.float32), np.zeros(4, np.int64), {}),
        (np.zeros(0, np.float32), np.zeros(0, np.int64), {}),
        (np.float32(0.5), np.int64(1), {}),
        (np.zeros(3, np.int64), np.zeros(3, np.int64), {}),
        (np.zeros(3, np.float32), np.zeros(3, np.int64), {"k": -1}),
    ]
    for preds, target, kw in cases:
        got = _outcome(lambda: port_f.retrieval_precision(torch.as_tensor(preds), torch.as_tensor(target), **kw))
        assert got == _outcome(lambda: ref_f.retrieval_precision(jnp.asarray(preds), jnp.asarray(target), **kw))
        assert isinstance(got, tuple)


# ---------------------------------------------------------------------------
# segment ops and trap C.6 (int32 query ids)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True])
def test_group_by_query_matches_reference(padded):
    """Sorted rows, group ids, ranks, sizes and starts are exact (NaN scores
    last in their query, ties in input order), padding rows and the empty
    groups of a larger bound included."""
    n = CAPACITY if padded else ROWS
    idx = np.concatenate([INDEXES.astype(np.int32), np.zeros(n - ROWS, np.int32)])
    preds = np.concatenate([PREDS, np.full(n - ROWS, 0.5, np.float32)])
    target = np.concatenate([BINARY.astype(np.int32), np.ones(n - ROWS, np.int32)])
    valid = np.arange(n) < ROWS
    kw = dict(num_groups=BOUND, valid=valid) if padded else {}
    got = port_segment.group_by_query(torch.from_numpy(idx), torch.from_numpy(preds), torch.from_numpy(target),
                                      **{k: torch.from_numpy(v) if k == "valid" else v for k, v in kw.items()})
    want = ref_segment.group_by_query(jnp.asarray(idx), jnp.asarray(preds), jnp.asarray(target),
                                      **{k: jnp.asarray(v) if k == "valid" else v for k, v in kw.items()})
    assert got.num_groups == want.num_groups
    inside = np.asarray(want.gid) < want.num_groups
    for field in ("preds", "target", "gid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    np.testing.assert_array_equal(got.rank.numpy()[inside], np.asarray(want.rank)[inside])
    np.testing.assert_array_equal(got.group_sizes.numpy(), np.asarray(want.group_sizes))
    np.testing.assert_array_equal(got.group_start.numpy(), np.asarray(want.group_start))
    for op in ("segment_sum", "segment_min", "segment_cumsum"):
        values = np.asarray(want.target)
        a = getattr(port_segment, op)(torch.from_numpy(values), got).numpy()
        b = np.asarray(getattr(ref_segment, op)(jnp.asarray(values), want))
        if op == "segment_cumsum":
            a, b = a[inside], b[inside]
        np.testing.assert_array_equal(a, b, err_msg=op)
    ideal, ideal_rank = port_segment.relevance_sorted(got)
    want_ideal, want_rank = ref_segment.relevance_sorted(want)
    np.testing.assert_array_equal(ideal.numpy()[inside], np.asarray(want_ideal)[inside])
    np.testing.assert_array_equal(ideal_rank.numpy()[inside], np.asarray(want_rank)[inside])


def test_nan_and_tied_scores_rank_as_the_reference():
    """[0.5, nan, 0.5] in one query ranks [1, 3, 2] by input row, as the JAX
    package's ``lexsort`` ranks it; -0.0 ties 0.0, as in its sort."""
    for preds, ranks in (([0.5, np.nan, 0.5], [1, 3, 2]), ([0.0, -0.0, 0.0, 1.0], [2, 3, 4, 1])):
        preds = np.asarray(preds, np.float32)
        idx = np.zeros(len(preds), np.int32)
        tgt = np.zeros(len(preds), np.int32)
        g = port_segment.group_by_query(torch.from_numpy(idx), torch.from_numpy(preds), torch.from_numpy(tgt))
        by_row = np.empty(len(preds), np.int64)
        order = port_segment._lexsort(torch.from_numpy(idx), port_segment.descending_key(torch.from_numpy(preds)))
        by_row[order.numpy()] = g.rank.numpy()
        assert by_row.tolist() == ranks


def test_query_ids_wrap_to_int32_as_the_reference():
    """Ids of 2**31 and above wrap as the JAX package's astype(int32): 2**31+5
    becomes -2147483643, and 2**32 + id joins query id. On the main data
    (its shapes), with half of one query's rows re-keyed past 2**32 and
    another query moved to 2**31 + 5."""
    ids = INDEXES.copy()
    ids[np.flatnonzero(ids == IDS[2])[::2]] += 2**32
    ids[ids == IDS[3]] = 2**31 + 5
    checked = _check_retrieval_inputs(torch.from_numpy(ids), torch.from_numpy(PREDS), torch.from_numpy(BINARY))[0]
    want = ref.utils.checks._check_retrieval_inputs(jnp.asarray(ids), jnp.asarray(PREDS), jnp.asarray(BINARY))[0]
    assert checked.dtype == torch.int32 and checked.tolist() == np.asarray(want).tolist()
    assert sorted(set(checked.tolist())) == sorted(set(INDEXES.tolist()) - {IDS[3]} | {-2147483643})
    for name in ("RetrievalMAP", "RetrievalMRR"):
        m_port, m_ref = getattr(port, name)(device="cpu"), getattr(ref, name)()
        m_port.update(torch.from_numpy(PREDS), torch.from_numpy(BINARY), indexes=torch.from_numpy(ids))
        m_ref.update(jnp.asarray(PREDS), jnp.asarray(BINARY), indexes=jnp.asarray(ids))
        np.testing.assert_allclose(float(m_port.compute()), float(m_ref.compute()), atol=ATOL)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_reserved_sentinel_id_raises_as_the_reference(dtype):
    """In padded mode the id 2**31 - 1 is the padding sentinel whatever dtype
    the caller passed (the ids are int32): both packages raise the same
    ValueError. In list mode the id is an ordinary query."""
    ids = INDEXES.astype(dtype)
    ids[ids == IDS[4]] = 2**31 - 1

    def run(pkg, arr, capacity, **kw):
        m = pkg.RetrievalMAP(num_queries=BOUND if capacity else None, **kw)
        if capacity:
            m.with_capacity(capacity)
        _feed_ids(m, ids, arr)
        return lambda: m.compute()

    got = _outcome(run(port, torch.from_numpy, CAPACITY, device="cpu"))
    assert got == _outcome(run(ref, jnp.asarray, CAPACITY))
    assert got[0] is ValueError and "reserved as the padding sentinel" in got[1] and "iinfo(int32)" in got[1]
    np.testing.assert_allclose(_outcome(run(port, torch.from_numpy, None, device="cpu")),
                               _outcome(run(ref, jnp.asarray, None)), atol=ATOL)


def _feed_ids(m, ids, arr):
    for sl in _batches(BINARY)[0]:
        m.update(arr(PREDS[sl]), arr(BINARY[sl]), indexes=arr(ids[sl]))


def test_num_queries_bound_below_the_data_raises_as_the_reference():
    got = _outcome(lambda: _port_module("RetrievalMAP", None, "neg", BINARY, num_queries=QUERIES - 1))
    assert got == _outcome(lambda: _ref_module("RetrievalMAP", None, "neg", BINARY, num_queries=QUERIES - 1))
    assert got[0] is ValueError and "static upper bound on DISTINCT" in got[1]


@pytest.mark.parametrize("kind", ["module", "collection"])
def test_num_queries_bound_below_the_data_raises_in_padded_mode(kind):
    """With ``with_capacity`` the valid rows keep their dense group ids, so
    a bound below the data's distinct ids raises as in list mode, never
    drops the surplus queries: the port against the JAX padded path."""
    if kind == "module":
        got = _outcome(lambda: _port_module("RetrievalMAP", None, "neg", BINARY,
                                            num_queries=QUERIES - 1, capacity=CAPACITY))
        want = _outcome(lambda: _ref_module("RetrievalMAP", None, "neg", BINARY,
                                            num_queries=QUERIES - 1, capacity=CAPACITY))
    else:
        def run_port():
            rc = port.RetrievalCollection(_members(port, device="cpu"), num_queries=QUERIES - 1, device="cpu")
            return _feed(rc.with_capacity(CAPACITY), BINARY, torch.from_numpy).compute()

        def run_ref():
            rc = ref.RetrievalCollection(_members(ref), num_queries=QUERIES - 1)
            return _feed(rc.with_capacity(CAPACITY), BINARY, jnp.asarray).compute()

        got, want = _outcome(run_port), _outcome(run_ref)
    assert got == want
    assert got[0] is ValueError and "static upper bound on DISTINCT" in got[1]
    assert f"the data holds {QUERIES} distinct ids" in got[1]


def test_data_helpers_match_the_reference():
    got = port_data.get_group_indexes(torch.from_numpy(INDEXES))
    want = ref_data.get_group_indexes(jnp.asarray(INDEXES))
    assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
    assert all(g.dtype == torch.int32 for g in got)
    tree = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": port.CatBuffer(4).append(torch.ones(2))}
    out = port_data.apply_to_collection(tree, torch.Tensor, lambda x: x * 2)
    assert out["a"][0].tolist() == [2.0, 2.0] and out["a"][1][1] == 3
    assert out["b"].values().tolist() == [2.0, 2.0] and out["b"].capacity == 4
    assert port_data.apply_to_collection(tree, int, lambda x: x + 1)["b"].count == 3


# ---------------------------------------------------------------------------
# two ranks on threads, queries straddling the ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["list", "capacity"])
def test_two_rank_sync_equals_one_process(monkeypatch, mode):
    """Each rank takes every other row, so every query has rows on both
    ranks; the synced collection equals one process over rank 0's rows then
    rank 1's, bit for bit, and the JAX package within ``ATOL``."""
    world = TorchLockstepWorld(2).install(monkeypatch)
    num_queries, capacity = (None, None) if mode == "list" else (QUERIES, ROWS)

    def make(local_capacity):
        rc = port.RetrievalCollection(_members(port, device="cpu"), num_queries=num_queries, device="cpu")
        return rc.with_capacity(local_capacity) if local_capacity else rc

    def body(rank):
        rc = make(capacity and ROWS // 2)
        rows = np.arange(rank, ROWS, 2)
        rc.update(torch.from_numpy(PREDS[rows]), torch.from_numpy(BINARY[rows]),
                  indexes=torch.from_numpy(INDEXES[rows]))
        return rc.compute()

    results = world.run(body)
    assert world.calls > 0
    # the gather concatenates in rank order, which decides the order of tied
    # scores: one process (and the JAX package) takes the rows in that order
    order = np.concatenate([np.arange(0, ROWS, 2), np.arange(1, ROWS, 2)])
    monkeypatch.undo()
    one = make(capacity)
    one.update(torch.from_numpy(PREDS[order]), torch.from_numpy(BINARY[order]),
               indexes=torch.from_numpy(INDEXES[order]))
    want = one.compute()
    rc_ref = ref.RetrievalCollection(_members(ref))
    rc_ref.update(jnp.asarray(PREDS[order]), jnp.asarray(BINARY[order]), indexes=jnp.asarray(INDEXES[order]))
    want_ref = rc_ref.compute()
    for got in results:
        for key, v in want.items():
            assert torch.equal(got[key], v), key
            np.testing.assert_allclose(float(v), float(want_ref[key]), atol=ATOL, err_msg=key)
