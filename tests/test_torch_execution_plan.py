"""The one execution plan and ``compiled_step`` on the CPU, against the JAX package.

Port twin of ``tests/core/test_execution_plan.py``, case for case:

- ONE schema-keyed store: ``build_sync_plan`` is a view over
  ``plan_for(...).sync_layout`` (same object, shared counters, one
  ``clear_plans``), ``schema_crc`` is the health word's CRC;
- ``compiled_step`` (update, in-program fused sync, compute as one program;
  on a CPU tensor the program-mode function runs directly, the function the
  card captures) equals the separate ``pure_update``/``pure_sync``/
  ``pure_compute`` phases bit for bit, and the JAX package's values (counts
  bit for bit, float values within 1e-6), for a metric and a grouped
  collection; an untraceable update falls back, loudly, to the separate
  phases; ``METRICS_TPU_UNIFIED_PLAN=0`` restores them and caches nothing;
- every invalidation goes through ``plan.mark_state_mutated`` /
  ``plan.plan_invalidate``; epochs are monotonic; bindings never copy;
- two thread ranks accumulate through ``compiled_step`` and host-sync bit
  for bit as the legacy composition does.

Divergences, each a case below: the JAX package refuses an ``axis_name`` on
an eager ``compiled_step`` (a named axis means nothing outside a
``shard_map``); the port's eager call is its own program, so it takes a
process group (an NCCL one on the card, see
``tests/test_torch_compiled_cuda.py``) and refuses what is none. "Inside the
user's jit" is, here, inside a caller's program (``program_mode``, the
branch a caller's CUDA capture or ``torch.compile`` takes too).
"""
import copy
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu.core import plan as ref_plan
from metrics_tpu_torch.core import plan as plan_mod
from metrics_tpu_torch.core.compiled import program_mode
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.bucketing import build_sync_plan, sync_plan_cache_info
from metrics_tpu_torch.parallel.sync import host_sync_state
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.helpers.torch_world import TorchLockstepWorld

rng = np.random.RandomState(23)
N_STEPS = 4
BATCH = 32
NUM_CLASSES = 10
NP_PREDS = [rng.randint(0, NUM_CLASSES, (BATCH,)) for _ in range(N_STEPS)]
NP_TARGET = [rng.randint(0, NUM_CLASSES, (BATCH,)) for _ in range(N_STEPS)]
PREDS = [torch.from_numpy(x) for x in NP_PREDS]
TARGET = [torch.from_numpy(x) for x in NP_TARGET]


@pytest.fixture(autouse=True)
def _fresh_plan_store():
    plan_mod.clear_plans()
    yield
    plan_mod.clear_plans()


class SumMetric(Metric):
    def __init__(self, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + torch.sum(x)
        self.count = self.count + torch.tensor(x.shape[0], dtype=torch.int32)

    def compute(self):
        return self.total / self.count


class RefSumMetric(ref.Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", jnp.zeros((), jnp.float32), dist_reduce_fx="sum")
        self.add_state("count", jnp.zeros((), jnp.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + jnp.sum(x)
        self.count = self.count + jnp.asarray(x.shape[0], jnp.int32)

    def compute(self):
        return self.total / self.count


def _collection(pkg=port):
    kw = {"device": "cpu"} if pkg is port else {}
    k = dict(num_classes=NUM_CLASSES, average="macro", **kw)
    return pkg.MetricCollection({
        "prec": pkg.Precision(**k), "rec": pkg.Recall(**k), "f1": pkg.F1(**k), "spec": pkg.Specificity(**k)})


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _leaves_equal(a, b):
    la, lb = _flat(a), _flat(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def _like_ref(got, want, atol=0.0):
    """A port leaf against a JAX one: counts equal, floats within atol."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0, atol=atol)


def _reference_run(owner, steps=N_STEPS):
    """The separate-phase composition the fused program must reproduce."""
    state, values = owner.init_state(), None
    for i in range(steps):
        state = owner.pure_update(state, PREDS[i], TARGET[i])
        values = owner.pure_compute(state)
    return state, values


# ---------------------------------------------------------------------------
# one schema-keyed store
# ---------------------------------------------------------------------------


def test_build_sync_plan_is_a_view_over_the_plan_store():
    m = SumMetric()
    state, reds = m.init_state(), m._reductions
    layout = build_sync_plan(state, reds)
    plan = plan_mod.plan_for(state, reds)
    assert plan.sync_layout is layout  # the cached object, not a copy
    info = plan_mod.plan_cache_info()
    assert info["size"] == 1 and info["misses"] == 1 and info["hits"] >= 1
    view = sync_plan_cache_info()
    assert set(view) == {"size", "hits", "misses"}
    assert view["size"] == info["size"] and view["misses"] == info["misses"]
    plan_mod.clear_plans()
    assert plan_mod.plan_cache_info() == {"size": 0, "hits": 0, "misses": 0, "invalidations": 0}


def test_schema_crc_matches_health_word_hash():
    from metrics_tpu_torch.parallel.health import state_schema_hash

    m = SumMetric()
    plan = plan_mod.plan_for(m.init_state(), m._reductions)
    assert plan.schema_crc == state_schema_hash(m.init_state(), m._reductions)


def test_distinct_schemas_get_distinct_plans():
    a, b = SumMetric(), port.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    pa = plan_mod.plan_for(a.init_state(), a._reductions)
    pb = plan_mod.plan_for(b.init_state(), b._reductions)
    assert pa is not pb and pa.schema_key != pb.schema_key
    assert plan_mod.plan_cache_info()["size"] == 2


# ---------------------------------------------------------------------------
# invalidation funnel and lifecycle
# ---------------------------------------------------------------------------


def test_mark_state_mutated_clears_latch_and_bumps_generation():
    m = SumMetric()
    binding = plan_mod.binding(m)
    g0 = binding.generation
    plan_mod.mark_donation_ready(m)
    assert m.__dict__["_donation_ready"] is True
    plan_mod.mark_state_mutated(m, "state-read")
    assert m.__dict__["_donation_ready"] is False
    assert binding.generation == g0 + 1
    plan_mod.mark_state_mutated(m, "state-read")  # not owned, no schema change: nothing
    assert binding.generation == g0 + 1
    assert m.telemetry()["plan"]["invalidate_reasons"].get("state-read") == 1


def test_collection_membership_changes_route_through_plan_invalidate():
    col = _collection()
    binding = plan_mod.binding(col)
    g0 = binding.generation
    col.add_metrics({"acc": port.Accuracy(num_classes=NUM_CLASSES, device="cpu")})
    assert binding.generation == g0 + 1
    assert col.__dict__["_groups_stale"] is True
    reasons = col.telemetry()["collection"]["plan"]["invalidate_reasons"]
    assert reasons.get("membership-changed", 0) >= 1


def test_sync_epoch_is_monotonic_and_mirrored():
    m = SumMetric()
    e1 = plan_mod.next_sync_epoch(m)
    e2 = plan_mod.next_sync_epoch(m)
    assert e2 == e1 + 1
    assert m.__dict__["_sync_epoch"] == e2
    assert plan_mod.binding(m).sync_epoch == e2
    # the JAX package counts the same way
    r = RefSumMetric()
    assert (ref_plan.next_sync_epoch(r), ref_plan.next_sync_epoch(r)) == (e1, e2)


def test_binding_never_copies_or_pickles_its_programs():
    m = SumMetric()
    st, _ = m.compiled_step(m.init_state(), torch.ones(BATCH))
    assert plan_mod.peek_binding(m).programs  # something cached
    for clone in (copy.deepcopy(m), pickle.loads(pickle.dumps(m))):
        b = plan_mod.peek_binding(clone)
        assert b is None or not b.programs


# ---------------------------------------------------------------------------
# the whole-step program equals the separate phases (and the JAX package)
# ---------------------------------------------------------------------------


def test_compiled_step_metric_bit_identical_to_composition():
    m, r = SumMetric(), RefSumMetric()
    state, rstate_jax = m.init_state(), r.init_state()
    for i in range(N_STEPS):
        state, values = m.compiled_step(state, PREDS[i].to(torch.float32))
        rstate_jax, rvalues_jax = r.compiled_step(rstate_jax, jnp.asarray(NP_PREDS[i], jnp.float32))
    ref_m = SumMetric()
    rstate = ref_m.init_state()
    for i in range(N_STEPS):
        rstate = ref_m.pure_update(rstate, PREDS[i].to(torch.float32))
    _leaves_equal(state, rstate)
    _leaves_equal(values, ref_m.pure_compute(rstate))
    for name in ("total", "count"):
        _like_ref(state[name], rstate_jax[name])  # sums of small integers: exact
    _like_ref(values, rvalues_jax, atol=1e-7)
    # ONE program cached, and a real one (no refusal); the state threads in place
    progs = list(plan_mod.peek_binding(m).programs.values())
    assert len(progs) == 1 and not isinstance(progs[0], str)
    assert all(state[k] is progs[0].slots[k] for k in state)
    assert m.compile_stats()["dispatches"] == N_STEPS and m.compile_stats()["traces"] == 1


def test_compiled_step_grouped_collection_bit_identical():
    col, rcol = _collection(), _collection(ref)
    state, rstate_jax = col.init_state(), rcol.init_state()
    for i in range(N_STEPS):
        state, values = col.compiled_step(state, PREDS[i], TARGET[i])
        rstate_jax, rvalues_jax = rcol.compiled_step(rstate_jax, jnp.asarray(NP_PREDS[i]), jnp.asarray(NP_TARGET[i]))
    rstate, rvalues = _reference_run(_collection())
    _leaves_equal(state, rstate)
    assert sorted(values) == sorted(rvalues) == sorted(rvalues_jax)
    for k in rvalues:
        _leaves_equal(values[k], rvalues[k])
        _like_ref(values[k], rvalues_jax[k], atol=1e-6)
    for k in state:
        for name in state[k]:
            _like_ref(state[k][name], rstate_jax[k][name])
    progs = list(plan_mod.peek_binding(col).programs.values())
    assert progs and all(not isinstance(p, str) for p in progs)
    assert col.telemetry()["collection"]["plan"]["fused_steps"] == N_STEPS
    assert rcol.telemetry()["collection"]["plan"]["fused_steps"] == N_STEPS


def test_untraceable_update_falls_back_to_eager_composition():
    m = port.Accuracy(device="cpu")  # infers num_classes from data: its mode latch cannot replay
    state = m.init_state()
    with pytest.warns(UserWarning, match="compiled eager step disabled"):
        for i in range(N_STEPS):
            state, values = m.compiled_step(state, PREDS[i], TARGET[i])
    rstate, rvalues = _reference_run(port.Accuracy(device="cpu"))
    _leaves_equal(state, rstate)
    _leaves_equal(values, rvalues)
    progs = list(plan_mod.peek_binding(m).programs.values())
    assert progs and all(isinstance(p, str) for p in progs)  # a cached refusal
    assert "step" in m.compile_stats()["fallback"]  # and a loud one
    r = ref.Accuracy()
    rs = r.init_state()
    for i in range(N_STEPS):
        rs, rv = r.compiled_step(rs, jnp.asarray(NP_PREDS[i]), jnp.asarray(NP_TARGET[i]))
    _like_ref(values, rv, atol=1e-7)


def test_escape_hatch_restores_legacy_composition(monkeypatch):
    monkeypatch.setenv(plan_mod.UNIFIED_PLAN_ENV, "0")
    assert not plan_mod.unified_plan_enabled()
    col = _collection()
    state = col.init_state()
    for i in range(N_STEPS):
        state, values = col.compiled_step(state, PREDS[i], TARGET[i])
    rstate, rvalues = _reference_run(_collection())
    _leaves_equal(state, rstate)
    for k in rvalues:
        _leaves_equal(values[k], rvalues[k])
    b = plan_mod.peek_binding(col)
    assert b is None or not b.programs  # the legacy path caches nothing


def test_eager_axis_name_is_a_user_error():
    """Divergence: the JAX package refuses any axis on an eager call; the
    port refuses an axis that is no process group (the JAX package's
    mesh-axis string) and takes a group (the thread-world case below)."""
    m = SumMetric()
    with pytest.raises(MetricsTPUUserError, match="process group"):
        m.compiled_step(m.init_state(), torch.ones(4), axis_name="w")
    with pytest.raises(ref.utils.exceptions.MetricsTPUUserError):
        RefSumMetric().compiled_step(RefSumMetric().init_state(), jnp.ones((4,), jnp.float32), axis_name="w")


def test_compiled_step_inside_users_jit_with_fused_sync(monkeypatch):
    """Inside a caller's program the step runs inline (counted once per call
    skeleton) and its fused in-program sync, over the two thread ranks'
    group, plans through the one store; the values are the world's."""
    world = TorchLockstepWorld(2).install(monkeypatch)
    axis = world.axis("world")

    def body(rank):
        col = _collection()
        state = col.init_state()
        with program_mode():
            for i in range(N_STEPS):
                state, values = col.compiled_step(state, PREDS[i], (TARGET[i] + rank) % NUM_CLASSES, axis_name=axis)
        fused = col.telemetry()["collection"]["plan"]["fused_steps"]
        return state, values, fused

    try:
        out = world.run(body)
    finally:
        world.shutdown_executors()
    one = _collection()
    ost = one.init_state()
    for i in range(N_STEPS):
        for rank in range(2):
            ost = one.pure_update(ost, PREDS[i], (TARGET[i] + rank) % NUM_CLASSES)
    want = one.pure_compute(ost)
    for rank, (state, values, fused) in enumerate(out):
        rstate, _ = _reference_run_shifted(rank)
        _leaves_equal(state, rstate)  # the carry is this rank's own accumulation
        for k in want:
            _leaves_equal(values[k], want[k])  # the values the world's (counts summed exactly)
        assert fused == 1  # once per call skeleton inside the program
    assert plan_mod.plan_cache_info()["size"] >= 1


def _reference_run_shifted(rank):
    owner = _collection()
    state = owner.init_state()
    for i in range(N_STEPS):
        state = owner.pure_update(state, PREDS[i], (TARGET[i] + rank) % NUM_CLASSES)
    return state, owner.pure_compute(state)


def test_compiled_step_eager_axis_over_thread_world(monkeypatch):
    """The port's eager call with a group (on the CPU the program runs its
    collectives directly): values are the world's, every step a program."""
    world = TorchLockstepWorld(2).install(monkeypatch)

    def body(rank):
        m = SumMetric()
        state = m.init_state()
        for i in range(N_STEPS):
            state, value = m.compiled_step(state, PREDS[i].float() + rank, axis_name=world.axis("world"))
        return float(value), m.compile_stats()["dispatches"]

    try:
        out = world.run(body)
    finally:
        world.shutdown_executors()
    total = sum(float(PREDS[i].float().sum()) * 2 + BATCH for i in range(N_STEPS))
    for value, dispatches in out:
        assert value == pytest.approx(total / (2 * BATCH * N_STEPS), rel=1e-7)
        assert dispatches == N_STEPS


# ---------------------------------------------------------------------------
# two thread ranks: the unified accumulation syncs bit for bit
# ---------------------------------------------------------------------------


def test_lockstep_unified_vs_legacy_host_sync_bit_identical(monkeypatch):
    world = TorchLockstepWorld(2).install(monkeypatch)

    def unified_body(rank):
        m = SumMetric()
        state = m.init_state()
        for i in range(N_STEPS):
            state, _ = m.compiled_step(state, PREDS[i].float() + rank)
        return host_sync_state(state, m._reductions, update_count=N_STEPS, timeout=0, fused=True)

    def legacy_body(rank):
        m = SumMetric()
        state = m.init_state()
        for i in range(N_STEPS):
            state = m.pure_update(state, PREDS[i].float() + rank)
        return host_sync_state(state, m._reductions, update_count=N_STEPS, timeout=0, fused=False)

    try:
        unified = world.run(unified_body)
        legacy = world.run(legacy_body)
    finally:
        world.shutdown_executors()
    for rank in range(2):
        _leaves_equal(unified[rank], legacy[rank])
    _leaves_equal(unified[0], unified[1])  # the collectives are symmetric
    assert plan_mod.plan_cache_info()["hits"] >= 1  # the ranks shared ONE plan


def test_fused_step_refusal_matches_the_jax_package():
    cases = [
        (lambda pkg, kw: pkg.AUROC(**kw), "growing list"),
        (lambda pkg, kw: pkg.Precision(num_classes=3, **kw), None),
    ]
    for make, want in cases:
        got = plan_mod.fused_step_refusal(make(port, {"device": "cpu"}))
        exp = ref_plan.fused_step_refusal(make(ref, {}))
        assert (got is None) == (exp is None) and (want is None or want in got), (got, exp)
    with pytest.raises(MetricsTPUUserError, match="growing list"):
        m = port.AUROC(device="cpu")
        m.compiled_step(m.init_state(), torch.rand(4), torch.tensor([0, 1, 0, 1]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cb = port.AUROC(device="cpu").with_capacity(8)
        st = cb.init_state()
        st = cb.pure_update(st, torch.rand(4), torch.tensor([0, 1, 0, 1]))
        st2, v = cb.compiled_step(st, torch.rand(4), torch.tensor([1, 0, 1, 0]))
    assert "CatBuffer" in cb.compile_stats()["fallback"]["step"]  # refused, loudly, and run in phases
    assert st2["preds"].count == 8 and torch.isfinite(v)
