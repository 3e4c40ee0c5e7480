"""The compiled hot path on the CPU: compiled ≡ eager, and the fallbacks.

Port twin of ``tests/bases/test_compiled_update.py`` and
``tests/bases/test_donation.py``. On a CPU tensor a program is the same
program-mode function a CUDA graph captures on the card
(``metrics_tpu_torch/core/compiled.py``), so these cases run the captured
code: state leaves, values, update counts, poison flags and CatBuffer counts
equal the eager path's bit for bit; untraceable metrics fall back with a
one-time diagnostic; the knobs restore pure eager; a state tensor handed out
keeps its value across later compiled updates. ``compile_stats()`` (traces,
dispatches, fallback kinds) equals the JAX package's for the same calls.
The card's graph replays of the same cases are in
``tests/test_torch_compiled_cuda.py``.
"""
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu_torch import (
    ROC,
    Accuracy,
    AveragePrecision,
    F1,
    MetricCollection,
    Precision,
    PrecisionRecallCurve,
    Recall,
    Specificity,
)
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.compiled import (
    COMPILED_UPDATE_ENV,
    COMPILED_WARMUP_ENV,
    TRACE_WARN_ENV,
    probe_traceable,
)
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

rng = np.random.RandomState(17)
N_STEPS = 6
BATCH = 64
NP_PREDS = [rng.rand(BATCH, 10).astype(np.float32) for _ in range(N_STEPS)]
NP_TARGET = [rng.randint(0, 10, (BATCH,)) for _ in range(N_STEPS)]
NP_BPREDS = [rng.rand(BATCH).astype(np.float32) for _ in range(N_STEPS)]
NP_BTARGET = [rng.randint(0, 2, (BATCH,)) for _ in range(N_STEPS)]
PREDS = [torch.from_numpy(x) for x in NP_PREDS]
TARGET = [torch.from_numpy(x) for x in NP_TARGET]
BPREDS = [torch.from_numpy(x) for x in NP_BPREDS]
BTARGET = [torch.from_numpy(x) for x in NP_BTARGET]


def _leaves(v):
    if v is None:
        return []
    if isinstance(v, CatBuffer):
        return [torch.tensor([v.capacity, v.count, int(v.overflowed)]), v.values()]
    if isinstance(v, (list, tuple)):
        return [leaf for x in v for leaf in _leaves(x)]
    if isinstance(v, dict):
        return [leaf for k in sorted(v) for leaf in _leaves(v[k])]
    return [v]


def leaves_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def assert_states_equal(eager, compiled, what=""):
    se, sc = eager._state, compiled._state
    assert sorted(se) == sorted(sc)
    for name in se:
        assert leaves_equal(se[name], sc[name]), f"{what}: {name}"


class SumMetric(Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + torch.sum(x)
        self.count = self.count + x.shape[0]

    def compute(self):
        return self.total / self.count


class CatMetric(Metric):
    """A cat state: a CatBuffer (with_capacity) compiles, the growing list is
    a declared static fallback."""

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("rows", [], dist_reduce_fx="cat")

    def update(self, x):
        self.rows.append(x)

    def compute(self):
        return torch.sum(dim_zero_cat(self.rows))


class LatchMetric(Metric):
    """An undeclared instance-attribute latch: the probe must catch it."""

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.seen_items = None

    def update(self, x):
        if self.seen_items is None:
            self.seen_items = int(np.prod(x.shape))
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class BranchMetric(Metric):
    """A data-dependent host read in update: untraceable."""

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("pos", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        if float(torch.sum(x)) > 0:
            self.pos = self.pos + torch.sum(x)

    def compute(self):
        return self.pos


class BranchPairMetric(Metric):
    """A (preds, target) metric whose update reads the host: only the probe
    can find it."""

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("pos", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds, target):
        if float(torch.sum(target)) >= 0:
            self.pos = self.pos + torch.sum(preds)

    def compute(self):
        return self.pos


def make_stat_collection(grouped=True):
    k = dict(num_classes=10, average="macro", device="cpu")
    return MetricCollection(
        {"prec": Precision(**k), "rec": Recall(**k), "f1": F1(**k), "spec": Specificity(**k)}, compute_groups=grouped
    )


def set_compiled(obj, flag):
    members = obj.values() if isinstance(obj, MetricCollection) else [obj]
    for m in members:
        m.compiled_update = flag
    return obj


def total_dispatches(mc):
    cs = mc.compile_stats()
    return cs["collection"]["dispatches"] + sum(s["dispatches"] for s in cs["members"].values())


# ---------------------------------------------------------------------------
# compiled ≡ eager
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("call", ["update", "forward"])
def test_stat_collection_bit_identical(grouped, call):
    eager = set_compiled(make_stat_collection(grouped), False)
    compiled = set_compiled(make_stat_collection(grouped), True)
    for i in range(N_STEPS):
        ve = getattr(eager, call)(PREDS[i], TARGET[i])
        vc = getattr(compiled, call)(PREDS[i], TARGET[i])
        assert leaves_equal(ve, vc), i
    for (k, me), mc in zip(eager.items(), compiled.values()):
        assert_states_equal(me, mc, k)
        assert me._update_count == mc._update_count == N_STEPS
        assert mc._update_called
    assert leaves_equal(eager.compute(), compiled.compute())
    assert total_dispatches(compiled) > 0 and total_dispatches(eager) == 0


@pytest.mark.parametrize(
    "make,batches",
    [
        (SumMetric, [(p,) for p in BPREDS]),
        (lambda: Precision(num_classes=10, average="macro", device="cpu"), list(zip(PREDS, TARGET))),
    ],
    ids=["sum", "precision"],
)
def test_solo_metric_update_and_forward_identical(make, batches):
    eager, compiled = set_compiled(make(), False), set_compiled(make(), True)
    for batch in batches:
        eager.update(*batch)
        compiled.update(*batch)
    assert_states_equal(eager, compiled)
    assert leaves_equal(eager.compute(), compiled.compute())
    eager, compiled = set_compiled(make(), False), set_compiled(make(), True)
    for i, batch in enumerate(batches):
        assert leaves_equal(eager(*batch), compiled(*batch)), i
    assert_states_equal(eager, compiled)
    assert compiled.compile_stats()["dispatches"] > 0


@pytest.mark.parametrize("call", ["update", "forward"])
def test_catbuffer_metric_compiles_bit_identical(call):
    eager = set_compiled(CatMetric().with_capacity(BATCH * N_STEPS), False)
    compiled = set_compiled(CatMetric().with_capacity(BATCH * N_STEPS), True)
    for i in range(N_STEPS):
        assert leaves_equal(getattr(eager, call)(BPREDS[i]), getattr(compiled, call)(BPREDS[i])), i
    assert_states_equal(eager, compiled)
    assert leaves_equal(eager.compute(), compiled.compute())
    stats = compiled.compile_stats()
    # the first step materializes the buffer eagerly; every later one replays
    assert stats["dispatches"] == N_STEPS - 1 and stats["fallback"] is None


def test_a_state_that_takes_the_batch_width_compiles_from_its_second_step():
    def make(flag):
        return set_compiled(port.ExplainedVariance(multioutput="raw_values", device="cpu"), flag)

    eager, compiled = make(False), make(True)
    for i in range(3):
        a = (PREDS[i][:, :3], PREDS[i + 1][:, :3])
        eager.update(*a)
        compiled.update(*a)
    # the first update turns the scalar defaults into [3] sums: eagerly
    assert_states_equal(eager, compiled)
    assert leaves_equal(eager.compute(), compiled.compute())
    stats = compiled.compile_stats()
    assert (stats["traces"], stats["dispatches"], stats["fallback"]) == (1, 2, None)


def test_catbuffer_device_offset_follows_the_host_count():
    m = set_compiled(CatMetric().with_capacity(BATCH * N_STEPS), True)
    for i in range(3):
        m.update(BPREDS[i])
    slot = next(iter(m._compiled_dispatcher().slots.values()))["rows"]
    assert m._raw_state()["rows"] is slot and slot.count == 3 * BATCH and int(slot._offset) == 3 * BATCH
    m.reset()  # the count changes outside a program: the next dispatch seeds the offset again
    m.update(BPREDS[3])
    m.update(BPREDS[4])
    assert int(slot._offset) == slot.count == 2 * BATCH
    assert torch.equal(m.rows.values(), torch.cat([BPREDS[3], BPREDS[4]]))


def test_catbuffer_overflow_raises_on_compiled_path_before_it_writes():
    m = set_compiled(CatMetric().with_capacity(BATCH * 2), True)
    m.update(BPREDS[0])
    m.update(BPREDS[1])
    assert m.compile_stats()["dispatches"] == 1
    with pytest.raises(MetricsTPUUserError, match="overflow"):
        m.update(BPREDS[2])
    # as in eager: nothing was written, the accumulation stays readable
    assert not m.rows.overflowed and len(m.rows) == 2 * BATCH
    assert torch.equal(m.compute(), torch.sum(torch.cat(BPREDS[:2])))


def test_growing_list_state_is_static_fallback():
    m = set_compiled(CatMetric(), True)
    for i in range(3):
        m.update(BPREDS[i])
    stats = m.compile_stats()
    assert stats["dispatches"] == 0 and "list state" in stats["fallback"]["update"]
    assert leaves_equal(m.compute(), torch.sum(torch.cat(BPREDS[:3])))


def test_check_finite_poison_flag_identical_and_forward_falls_back():
    bad = torch.tensor(np.r_[np.full(8, np.inf), np.zeros(8)].astype(np.float32))
    eager = set_compiled(SumMetric(check_finite=True), False)
    compiled = set_compiled(SumMetric(check_finite=True), True)
    for m in (eager, compiled):
        m.update(BPREDS[0])
        m.update(bad)
    assert_states_equal(eager, compiled)
    assert int(compiled._state["_nonfinite"]) == 1 and compiled.compile_stats()["dispatches"] > 0
    for m in (eager, compiled):
        with pytest.raises(Exception, match="non-finite"):
            m.compute()
    f = set_compiled(SumMetric(check_finite=True), True)
    f(BPREDS[0])
    assert "check_finite" in f.compile_stats()["fallback"]["forward"]


def test_grouped_collection_with_midrun_detach_identical():
    eager = set_compiled(make_stat_collection(True), False)
    compiled = set_compiled(make_stat_collection(True), True)
    for i in range(3):
        eager.update(PREDS[i], TARGET[i])
        compiled.update(PREDS[i], TARGET[i])
    eager["rec"].update(PREDS[3], TARGET[3])
    compiled["rec"].update(PREDS[3], TARGET[3])
    assert compiled["rec"]._compute_group is None
    for i in range(4, N_STEPS):
        eager.update(PREDS[i], TARGET[i])
        compiled.update(PREDS[i], TARGET[i])
    for (k, me), mc in zip(eager.items(), compiled.values()):
        assert_states_equal(me, mc, k)
    assert leaves_equal(eager.compute(), compiled.compute())


def test_curve_family_falls_back_and_stays_identical():
    def make():
        cap = BATCH * N_STEPS
        return MetricCollection({
            "roc": ROC(device="cpu").with_capacity(cap),
            "prc": PrecisionRecallCurve(device="cpu").with_capacity(cap),
            "ap": AveragePrecision(device="cpu").with_capacity(cap),
        })

    eager, compiled = set_compiled(make(), False), set_compiled(make(), True)
    for i in range(N_STEPS):
        eager.update(BPREDS[i], BTARGET[i])
        compiled.update(BPREDS[i], BTARGET[i])
    for (k, me), mc in zip(eager.items(), compiled.values()):
        assert_states_equal(me, mc, k)
    assert total_dispatches(compiled) == 0
    reasons = [s["fallback"]["update"] for s in compiled.compile_stats()["members"].values() if s["fallback"]]
    assert reasons and all("side-effect" in r for r in reasons)


def test_accuracy_mode_latch_falls_back_identical():
    eager = set_compiled(Accuracy(num_classes=10, device="cpu"), False)
    compiled = set_compiled(Accuracy(num_classes=10, device="cpu"), True)
    for i in range(N_STEPS):
        eager.update(PREDS[i], TARGET[i])
        compiled.update(PREDS[i], TARGET[i])
    assert_states_equal(eager, compiled)
    assert leaves_equal(eager.compute(), compiled.compute())
    stats = compiled.compile_stats()
    assert stats["dispatches"] == 0 and "side-effect" in stats["fallback"]["update"]
    assert compiled.mode == eager.mode


def test_mixed_collection_fallback_member_joins():
    def make():
        k = dict(num_classes=10, device="cpu")
        return MetricCollection(
            {"prec": Precision(average="macro", **k), "rec": Recall(average="macro", **k), "acc": Accuracy(**k)},
            compute_groups=False,
        )

    eager, compiled = set_compiled(make(), False), set_compiled(make(), True)
    for i in range(N_STEPS):
        eager.update(PREDS[i], TARGET[i])
        compiled.update(PREDS[i], TARGET[i])
    for (k, me), mc in zip(eager.items(), compiled.values()):
        assert_states_equal(me, mc, k)
    cs = compiled.compile_stats()
    assert cs["members"]["acc"]["fallback"] is not None
    assert cs["collection"]["dispatches"] == N_STEPS  # prec + rec in one program a step


def test_ungrouped_collection_fuses_to_one_dispatch_per_step():
    compiled = set_compiled(make_stat_collection(False), True)
    for i in range(N_STEPS):
        compiled.update(PREDS[i], TARGET[i])
    cs = compiled.compile_stats()
    assert cs["collection"]["dispatches"] == N_STEPS
    assert all(s["dispatches"] == 0 for s in cs["members"].values())


def test_probe_failing_member_shrinks_fused_program():
    def make():
        k = dict(num_classes=10, average="macro", device="cpu")
        return MetricCollection(
            {"prec": Precision(**k), "rec": Recall(**k), "branch": BranchPairMetric()}, compute_groups=False
        )

    mc, reference = set_compiled(make(), True), set_compiled(make(), False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(N_STEPS):
            mc.update(PREDS[i], TARGET[i])
            reference.update(PREDS[i], TARGET[i])
    cs = mc.compile_stats()
    assert cs["members"]["branch"]["fallback"], "the culprit is named"
    assert cs["collection"]["fallback"] is None, "the collection does not give up"
    assert cs["collection"]["dispatches"] == N_STEPS - 1, "the other members fuse again"
    for (k, me), mm in zip(reference.items(), mc.values()):
        assert_states_equal(me, mm, k)


def test_compiled_forward_memoization_parity():
    eager, compiled = set_compiled(SumMetric(), False), set_compiled(SumMetric(), True)
    for i in range(3):
        assert leaves_equal(eager(BPREDS[i]), compiled(BPREDS[i]))
        assert leaves_equal(eager._forward_cache, compiled._forward_cache)
    assert leaves_equal(eager.compute(), compiled.compute())
    assert leaves_equal(eager.compute(), compiled.compute())


def test_compiled_then_eager_interleave_identical():
    eager, mixed = set_compiled(SumMetric(), False), set_compiled(SumMetric(), True)
    for i in range(3):
        eager.update(BPREDS[i])
        mixed.update(BPREDS[i])
    mixed.compiled_update = False
    for i in range(3, N_STEPS):
        eager.update(BPREDS[i])
        mixed.update(BPREDS[i])
    assert_states_equal(eager, mixed)
    assert leaves_equal(eager.compute(), mixed.compute())


# ---------------------------------------------------------------------------
# the probe, the knobs, churn and storms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "body,reason",
    [
        (lambda s, x: {"total": s["total"] + float(torch.sum(x))}, "host read"),
        (lambda s, x: {"total": s["total"] + torch.nonzero(x).sum()}, "DynamicOutputShapeException"),
        (lambda s, x: {"total": s["total"] + torch.sum(x)}, None),
    ],
    ids=["host-read", "output-shape", "clean"],
)
def test_probe_reasons_on_fake_tensors(body, reason):
    got = probe_traceable(lambda state, dyn: body(state, dyn[0]), {"total": torch.zeros(())}, [BPREDS[0]], [])
    assert got is None if reason is None else (reason in got and "not traceable" in got)


def test_host_read_of_a_folded_constant_is_refused():
    """forward's batch state starts from the real defaults, so FakeTensorMode
    folds its count to a constant and would let ``int()`` of it through; a
    capture would refuse that read, so the probe does."""

    class CountMean(SumMetric):
        def compute(self):
            return self.total / int(self.count)

    m = set_compiled(CountMean(), True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(3):
            m(BPREDS[i])
            m.update(BPREDS[i])
    stats = m.compile_stats()
    assert "host read" in stats["fallback"]["forward"] and "update" not in stats["fallback"]
    assert stats["dispatches"] > 0


def test_env_escape_hatch_restores_pure_eager(monkeypatch):
    monkeypatch.setenv(COMPILED_UPDATE_ENV, "0")
    m = set_compiled(SumMetric(), True)
    for i in range(N_STEPS):
        m.update(BPREDS[i])
    stats = m.compile_stats()
    assert stats["dispatches"] == 0 and stats["traces"] == 0
    mc = set_compiled(make_stat_collection(False), True)
    mc.update(PREDS[0], TARGET[0])
    assert total_dispatches(mc) == 0


def test_per_metric_knob_false_restores_pure_eager():
    m = SumMetric(compiled_update=False)
    for i in range(N_STEPS):
        m.update(BPREDS[i])
    stats = m.compile_stats()
    assert stats["dispatches"] == 0 and stats["traces"] == 0 and stats["steps_seen"] == 0


def test_warmup_defers_first_trace(monkeypatch):
    monkeypatch.setenv(COMPILED_WARMUP_ENV, "3")
    m = SumMetric()
    for i in range(3):
        m.update(BPREDS[i])
    assert m.compile_stats()["traces"] == 0
    m.update(BPREDS[3])
    stats = m.compile_stats()
    assert stats["traces"] == 1 and stats["dispatches"] == 1


def test_untraceable_update_probe_fallback_one_time_diagnostic():
    m = set_compiled(BranchMetric(), True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(3):
            m.update(BPREDS[i])
    msgs = [str(w.message) for w in caught if "compiled eager" in str(w.message)]
    assert len(msgs) == 1 and "not traceable" in msgs[0]
    stats = m.compile_stats()
    assert stats["dispatches"] == 0 and "not traceable" in stats["fallback"]["update"]
    np.testing.assert_allclose(float(m.compute()), sum(float(np.sum(p)) for p in NP_BPREDS[:3]), rtol=1e-5)


@pytest.mark.parametrize("latch", ["attribute", "container"])
def test_undeclared_latch_probe_fallback(latch, monkeypatch):
    # the probe's own finding, with the static pre-classification off (as the
    # JAX suite's test_undeclared_latch_probe_fallback_without_preclassification):
    # with it on, LatchMetric is refuted statically before the probe
    # (tests/test_torch_analysis_runtime.py)
    monkeypatch.setenv("METRICS_TPU_ANALYSIS_PRECLASSIFY", "0")
    class AppendingMetric(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
            self.batch_sizes = []

        def update(self, x):
            self.batch_sizes.append(int(x.shape[0]))
            self.total = self.total + torch.sum(x)

        def compute(self):
            return self.total / len(self.batch_sizes)

    make = LatchMetric if latch == "attribute" else AppendingMetric
    eager, compiled = make(), set_compiled(make(), True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(3):
            eager.update(BPREDS[i])
            compiled.update(BPREDS[i])
    stats = compiled.compile_stats()
    assert stats["dispatches"] == 0 and "side-effect latch" in stats["fallback"]["update"]
    # the probe restored what it touched, and the eager path derived it as usual
    if latch == "attribute":
        assert "seen_items" in stats["fallback"]["update"] and compiled.seen_items == eager.seen_items == BATCH
    else:
        assert compiled.batch_sizes == eager.batch_sizes == [BATCH] * 3
    assert_states_equal(eager, compiled)


def test_shape_churn_warns_once(monkeypatch):
    monkeypatch.setenv(TRACE_WARN_ENV, "3")
    m = set_compiled(SumMetric(), True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for n in range(1, 8):
            m.update(torch.ones(n))
    assert len([w for w in caught if "retraced" in str(w.message)]) == 1
    assert m.compile_stats()["traces"] >= 3
    np.testing.assert_allclose(float(m.compute()), 1.0)


def test_recompile_storm_falls_back_permanently(monkeypatch):
    monkeypatch.setenv(TRACE_WARN_ENV, "2")  # the storm at 8
    m = set_compiled(SumMetric(), True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for n in range(1, 12):
            m.update(torch.ones(n))
    stats = m.compile_stats()
    assert "recompile storm" in stats["fallback"]["update"] and stats["traces"] == 8
    np.testing.assert_allclose(float(m.compute()), 1.0)


def test_per_batch_static_scalar_storms_to_eager(monkeypatch):
    monkeypatch.setenv(TRACE_WARN_ENV, "2")

    class WeightedSum(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x, weight):
            self.total = self.total + weight * torch.sum(x)

        def compute(self):
            return self.total

    eager, compiled = WeightedSum(), set_compiled(WeightedSum(), True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(12):
            eager.update(BPREDS[i % N_STEPS], 0.1 * (i + 1))
            compiled.update(BPREDS[i % N_STEPS], 0.1 * (i + 1))
    assert "recompile storm" in compiled.compile_stats()["fallback"]["update"]
    assert_states_equal(eager, compiled)


def test_ragged_tail_retraces_once_then_caches():
    m = set_compiled(SumMetric(), True)
    for _ in range(3):
        m.update(BPREDS[0])
        m.update(BPREDS[1][: BATCH // 2])
    stats = m.compile_stats()
    assert stats["traces"] == 2 and stats["dispatches"] == 6


def test_global_warning_filters_untouched():
    import metrics_tpu_torch.core.compiled  # noqa: F401 - the import under test

    assert not any(f[1] is not None and "donated" in getattr(f[1], "pattern", "") for f in warnings.filters)


# ---------------------------------------------------------------------------
# handed-out state (the donation contract of the JAX package)
# ---------------------------------------------------------------------------


def test_donation_never_invalidates_defaults_or_reset():
    m = set_compiled(SumMetric(), True)
    for i in range(N_STEPS):
        m.update(BPREDS[i])
    m.reset()
    assert float(m._state["total"]) == 0.0
    m.update(BPREDS[0])
    np.testing.assert_allclose(float(m._state["total"]), float(np.sum(NP_BPREDS[0])), rtol=1e-6)


@pytest.mark.parametrize("how", ["getattr", "state_dict", "clone", "sync-cache", "compute"])
def test_donation_never_invalidates_user_held_reference(how):
    m = set_compiled(SumMetric(), True)
    m.persistent(True)
    m.update(BPREDS[0])
    if how == "getattr":
        held = m.total
    elif how == "state_dict":
        held = m.state_dict()["total"]
    elif how == "clone":
        held = m.clone()._state["total"]
    elif how == "sync-cache":
        m.sync(dist_sync_fn=lambda s, r: {k: v * 2 for k, v in s.items()}, distributed_available=lambda: True)
        held = m._cache["total"]
        m.unsync()
    else:
        m.total  # noqa: B018 - a read between compiled steps
        held = m.compute()
    before = held.clone()
    for i in range(1, 4):
        m.update(BPREDS[i])
    assert torch.equal(held, before)
    np.testing.assert_allclose(float(m.total), sum(float(np.sum(p)) for p in NP_BPREDS[:4]), rtol=1e-5)


def test_donation_never_invalidates_clone():
    m = set_compiled(SumMetric(), True)
    m.update(BPREDS[0])
    c = m.clone()
    snap = float(c._state["total"])
    for i in range(1, 4):
        m.update(BPREDS[i])
    assert float(c._state["total"]) == snap
    c.update(BPREDS[1])
    assert c.compile_stats()["dispatches"] == 1


def test_two_instances_share_no_buffers():
    a, b = set_compiled(SumMetric(), True), set_compiled(SumMetric(), True)
    a.update(BPREDS[0])
    assert float(b._state["total"]) == 0.0


def test_sync_unsync_roundtrip_with_compiled_updates():
    m = set_compiled(SumMetric(), True)
    m.dist_sync_fn = lambda state, reductions: {k: v * 2 for k, v in state.items()}
    for i in range(3):
        m.update(BPREDS[i])
    local = {k: v.clone() for k, v in m._state.items()}
    m.sync(distributed_available=lambda: True)
    assert torch.equal(m._state["total"], local["total"] * 2)
    m.unsync()
    for k in local:
        assert torch.equal(m._state[k], local[k]), k
    m.update(BPREDS[3])
    np.testing.assert_allclose(float(m.total), float(local["total"]) + float(np.sum(NP_BPREDS[3])), rtol=1e-6)


def test_state_dict_snapshot_survives_later_compiled_updates():
    m = set_compiled(SumMetric(), True)
    m.persistent(True)
    m.update(BPREDS[0])
    snap = m.state_dict()
    frozen = {k: v.clone() for k, v in snap.items()}
    for i in range(1, 4):
        m.update(BPREDS[i])
    for k in snap:
        assert torch.equal(snap[k], frozen[k]), k


def test_state_dict_on_group_sibling_disarms_leader_donation():
    mc = set_compiled(make_stat_collection(True), True)
    for m in mc.values():
        m.persistent(True)
    for i in range(3):
        mc.update(PREDS[i], TARGET[i])
    leader = next(iter(mc.values()))._compute_group.members[0]
    assert leader.__dict__.get("_donation_ready", False)
    sibling = [m for m in mc.values() if m is not leader][0]
    snap = sibling.state_dict()
    frozen = {k: v.clone() for k, v in snap.items()}
    assert not leader.__dict__.get("_donation_ready", False)
    mc.update(PREDS[3], TARGET[3])
    for k in snap:
        assert torch.equal(snap[k], frozen[k]), k


def test_checkpointer_hook_fires_on_compiled_updates(tmp_path):
    from metrics_tpu_torch.core.checkpoint import load_checkpoint

    m, m2 = set_compiled(SumMetric(), True), SumMetric()
    with m.checkpointer(str(tmp_path), every_n_updates=2, rank=0, world=1):
        for i in range(4):
            m.update(BPREDS[i])
    load_checkpoint(m2, str(tmp_path), rank=0, world=1)
    assert_states_equal(m, m2)
    assert m.compile_stats()["dispatches"] > 0


def test_pickle_roundtrip_drops_programs_keeps_state():
    m = set_compiled(SumMetric(), True)
    for i in range(3):
        m.update(BPREDS[i])
    m2 = pickle.loads(pickle.dumps(m))
    assert_states_equal(m, m2)
    assert m2.compile_stats()["dispatches"] == 0
    m2.update(BPREDS[3])
    assert m2.compile_stats()["dispatches"] == 1


def test_eager_pure_update_stays_pure_alongside_compiled_path():
    m = set_compiled(SumMetric(), True)
    m.update(BPREDS[0])
    m.update(BPREDS[1])
    inst_total = float(m._state["total"])
    caller_state = m.init_state()
    out = m.pure_update(caller_state, BPREDS[2])
    assert float(caller_state["total"]) == 0.0
    np.testing.assert_allclose(float(out["total"]), float(np.sum(NP_BPREDS[2])), rtol=1e-6)
    assert float(m._state["total"]) == inst_total
    m.update(BPREDS[3])
    expected = sum(float(np.sum(NP_BPREDS[i])) for i in (0, 1, 3))
    np.testing.assert_allclose(float(m._state["total"]), expected, rtol=1e-5)
    m2 = set_compiled(SumMetric(), True)
    m2.pure_update(m2.init_state(), BPREDS[0])
    m2.update(BPREDS[1])
    m2.reset()
    assert float(m2._state["total"]) == 0.0


# ---------------------------------------------------------------------------
# compile_stats() against the JAX package's, for the same calls
# ---------------------------------------------------------------------------


class _RefSum(ref.Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", jnp.zeros((), jnp.float32), dist_reduce_fx="sum")
        self.add_state("count", jnp.zeros((), jnp.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + jnp.sum(x)
        self.count = self.count + jnp.asarray(x.shape[0], jnp.int32)

    def compute(self):
        return self.total / self.count


def _scenario(pkg, name):
    """One sequence of calls; returns its compile_stats() with fallback
    reasons reduced to their kinds."""
    jax_side = pkg is ref
    dev = {} if jax_side else {"device": "cpu"}
    conv = jnp.asarray if jax_side else torch.from_numpy

    def stat_collection(grouped, extra=()):
        k = dict(num_classes=10, average="macro", **dev)
        members = {"prec": pkg.Precision(**k), "rec": pkg.Recall(**k), "f1": pkg.F1(**k), "spec": pkg.Specificity(**k)}
        for key in extra:
            members[key] = pkg.Accuracy(num_classes=10, **dev)
        return pkg.MetricCollection(members, compute_groups=grouped)

    makes = {
        "sum": lambda: _RefSum() if jax_side else SumMetric(),
        "flagship": lambda: pkg.MetricCollection({
            "acc": pkg.Accuracy(num_classes=10, **dev), "stats": pkg.StatScores(reduce="macro", num_classes=10, **dev)}),
        "stats-grouped": lambda: stat_collection(True),
        "stats-ungrouped-acc": lambda: stat_collection(False, extra=("acc",)),
        "binned": lambda: pkg.BinnedAveragePrecision(num_classes=10, thresholds=20, **dev),
        "regression": lambda: pkg.MetricCollection({
            "mse": pkg.MeanSquaredError(**dev), "pearson": pkg.PearsonCorrcoef(**dev),
            "tweedie": pkg.TweedieDevianceScore(power=2.0, **dev)}),
    }
    obj = makes[name.split(":")[0]]()
    set_compiled_any(obj, True)
    call = name.split(":")[1]
    for i in range(4):
        if name.startswith("sum"):
            args = (conv(NP_BPREDS[i]),)
        elif name.startswith("regression"):
            args = (conv(NP_BPREDS[i] + 0.1), conv(NP_BPREDS[i + 1] + 0.1))
        else:
            args = (conv(NP_PREDS[i]), conv(NP_TARGET[i]))
        getattr(obj, call)(*args)
    cs = obj.compile_stats()
    if "members" not in cs:
        cs = {"collection": cs, "members": {}}

    def kinds(s):
        return (s["traces"], s["dispatches"], s["steps_seen"], sorted(s["fallback"] or {}))

    return {"collection": kinds(cs["collection"]), **{k: kinds(v) for k, v in cs["members"].items()}}


def set_compiled_any(obj, flag):
    for m in (obj.values() if hasattr(obj, "values") else [obj]):
        m.compiled_update = flag


SCENARIOS = [
    "sum:update", "sum:forward", "flagship:forward", "stats-grouped:update", "stats-grouped:forward",
    "stats-ungrouped-acc:update", "binned:forward", "regression:forward",
]


@pytest.fixture(scope="module")
def jax_compile_stats():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {name: _scenario(ref, name) for name in SCENARIOS}


@pytest.mark.parametrize("name", SCENARIOS)
def test_compile_stats_equal_the_jax_package(name, jax_compile_stats):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _scenario(port, name)
    assert got == jax_compile_stats[name]


# ---------------------------------------------------------------------------
# the donation file's cases (tests/bases/test_donation.py)
# ---------------------------------------------------------------------------


def test_default_state_leaves_are_distinct_buffers():
    mc = MetricCollection({"acc": Accuracy(num_classes=10, device="cpu"),
                           "stats": port.StatScores(reduce="macro", num_classes=10, device="cpu")})
    seen = set()
    for sub in mc.init_state().values():
        for v in sub.values():
            assert v.untyped_storage().data_ptr() not in seen, "aliased default buffers"
            seen.add(v.untyped_storage().data_ptr())


def test_pure_update_loop_and_reset():
    mc = MetricCollection({"acc": Accuracy(num_classes=10, device="cpu"),
                           "stats": port.StatScores(reduce="macro", num_classes=10, device="cpu")})
    state = mc.init_state()
    for i in range(N_STEPS):
        state = mc.pure_update(state, PREDS[i], TARGET[i])
    acc = float(mc.pure_compute(state)["acc"])
    np.testing.assert_allclose(acc, np.mean([np.argmax(p, -1) == t for p, t in zip(NP_PREDS, NP_TARGET)]), atol=1e-6)
    state2 = mc.pure_update(mc.init_state(), PREDS[0], TARGET[0])
    acc2 = float(mc.pure_compute(state2)["acc"])
    np.testing.assert_allclose(acc2, np.mean(np.argmax(NP_PREDS[0], -1) == NP_TARGET[0]), atol=1e-6)


def test_pure_catbuffer_loop():
    from sklearn.metrics import roc_auc_score

    m = port.AUROC(device="cpu").with_capacity(512)
    m.update(BPREDS[0], BTARGET[0])
    m.reset()
    state = m.pure_update(m.init_state(), BPREDS[0], BTARGET[0])
    for i in range(1, 4):
        before = state
        state = m.pure_update(state, BPREDS[i], BTARGET[i])
        assert len(before["preds"]) == BATCH * i  # the input state is unchanged
    want = roc_auc_score(np.concatenate(NP_BTARGET[:4]), np.concatenate(NP_BPREDS[:4]))
    np.testing.assert_allclose(float(m.pure_compute(state)), want, atol=1e-6)
