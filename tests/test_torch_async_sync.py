"""The overlapped sync on two thread ranks, against the JAX package.

Port twin of ``tests/parallel/test_async_sync.py``, case for case: a
non-blocking, double-buffered round (``parallel/async_sync.py``,
``sync(blocking=False)``, ``sync_mode="overlap"``) resolves bit for bit as a
blocking sync of the same updates (reduce states, CatBuffers, grouped
collections); staleness is reported by ``staleness_policy``; the round's
epoch rides the health word, so a mispairing raises on both ranks;
``unsync()`` mid-flight cancels by draining; checkpoints refuse an in-flight
round. Each rank is a thread of ``tests/helpers/torch_world.py``'s world with
a background lane of its own (``executor_for_current_rank``). The last case
runs one call sequence on both packages' thread worlds and holds the
``sync`` and ``plan`` telemetry counters to the JAX package's.
"""
import copy
import pickle
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch.parallel.async_sync as async_mod
from metrics_tpu_torch import MetricCollection, Precision, Recall
from metrics_tpu_torch.core import plan as plan_mod
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.bucketing import clear_sync_plan_cache, sync_plan_cache_info
from metrics_tpu_torch.parallel.health import reset_channel_health
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, StaleSyncError, StateDivergenceError
from tests.helpers.torch_world import TorchLockstepWorld

WORLD = 2


@pytest.fixture(autouse=True)
def _fresh_channel_and_plans():
    clear_sync_plan_cache()
    reset_channel_health()
    with async_mod._PENDING_LOCK:
        async_mod._PENDING.clear()
    yield
    clear_sync_plan_cache()
    reset_channel_health()
    with async_mod._PENDING_LOCK:
        async_mod._PENDING.clear()


@pytest.fixture
def lockstep(monkeypatch):
    world = TorchLockstepWorld(WORLD).install(monkeypatch)
    yield world
    world.shutdown_executors()


class _Sum(Metric):
    def __init__(self, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + torch.sum(x)
        self.count = self.count + torch.tensor(x.numel(), dtype=torch.int32)

    def compute(self):
        return self.total / self.count


class _Cat(Metric):
    def __init__(self, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(**kwargs)
        self.add_state("rows", [], dist_reduce_fx="cat")
        self.add_state("seen", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.rows.append(x)
        self.seen = self.seen + 1.0

    def compute(self):
        return torch.cat([r.reshape(1) if r.ndim == 0 else r for r in self.rows])


def _state_bytes(m):
    out = []
    for name in sorted(m._defaults):
        v = m._state[name]
        if isinstance(v, list):
            out.append(tuple(x.numpy().tobytes() for x in v))
        elif hasattr(v, "values") and hasattr(v, "capacity"):  # CatBuffer
            out.append(v.values().numpy().tobytes())
        else:
            out.append(v.numpy().tobytes())
    return tuple(out)


def _t(*x):
    return torch.tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# bit-identity: an overlapped resolve equals a blocking sync of the same updates
# ---------------------------------------------------------------------------


def test_overlap_resolves_bit_identical_reduce(lockstep):
    def body(rank):
        feed = _t(1.0 + rank, 2.0 * (rank + 1))
        over, block = _Sum(), _Sum()
        over.update(feed)
        block.update(feed)
        block.sync()
        over.sync(blocking=False)  # launch; returns un-synced
        assert not over._is_synced and over.__dict__["_inflight"] is not None
        over.sync()  # resolve the in-flight round
        assert over._is_synced
        bits = (_state_bytes(over), _state_bytes(block))
        over.unsync()
        block.unsync()
        stats = over.sync_stats()
        assert stats["launched"] == 1 and stats["resolved"] == 1 and stats["stale_resolves"] == 0
        return bits, _state_bytes(over), _state_bytes(block)

    for (synced_o, synced_b), local_o, local_b in lockstep.run(body):
        assert synced_o == synced_b
        assert local_o == local_b


def test_overlap_resolves_bit_identical_catbuffer(lockstep):
    def body(rank):
        over, block = _Cat().with_capacity(16), _Cat().with_capacity(16)
        for i in range(2 + rank):  # uneven rows per rank
            row = _t(float(rank), float(i), 1.0)
            over.update(row)
            block.update(row)
        block.sync()
        over.sync(blocking=False)
        over.sync()
        bits = (_state_bytes(over), _state_bytes(block))
        over.unsync()
        block.unsync()
        return bits, _state_bytes(over), _state_bytes(block)

    for (synced_o, synced_b), local_o, local_b in lockstep.run(body):
        assert synced_o == synced_b
        assert local_o == local_b


def _pr_collection(**kw):
    mc = MetricCollection({"prec": Precision(num_classes=5, average="macro", device="cpu"),
                           "rec": Recall(num_classes=5, average="macro", device="cpu")}, **kw)
    return mc


def test_overlap_grouped_collection_bit_identical(lockstep):
    preds = [torch.from_numpy(np.random.RandomState(3 + r).rand(24, 5).astype(np.float32)) for r in range(WORLD)]
    target = [torch.from_numpy(np.random.RandomState(7 + r).randint(0, 5, (24,))) for r in range(WORLD)]

    def body(rank):
        over, block = _pr_collection(), _pr_collection()
        over.update(preds[rank], target[rank])
        block.update(preds[rank], target[rank])
        assert over.compute_group_keys  # the pair grouped
        block.sync()
        over.sync(blocking=False)
        assert over.__dict__["_inflight_round"] is not None
        over.sync()  # resolve: every member applied, all or nothing
        bits = tuple(_state_bytes(m) for m in over.values())
        bbits = tuple(_state_bytes(m) for m in block.values())
        vals = {k: v.clone() for k, v in over.compute().items()}
        bvals = {k: v.clone() for k, v in block.compute().items()}
        over.unsync()
        block.unsync()
        stats = over.sync_stats()["collection"]
        assert stats["launched"] == 1 and stats["resolved"] == 1
        return bits, bbits, vals, bvals

    for bits, bbits, vals, bvals in lockstep.run(body):
        assert bits == bbits
        for k in vals:
            assert torch.equal(vals[k], bvals[k])


def test_collection_overlap_uses_one_fused_round(lockstep):
    def body(rank):
        mc = MetricCollection({"a": _Sum(), "b": _Sum()})
        mc.update(_t(1.0 + rank))
        before = lockstep.calls
        mc.sync(blocking=False)
        mc.sync()
        mc.unsync()
        return lockstep.calls - before

    # one header, one float32 bucket, one int32 bucket: the blocking fused
    # path's collectives, off the critical path
    assert lockstep.run(body)[0] <= 3


# ---------------------------------------------------------------------------
# staleness policies
# ---------------------------------------------------------------------------


def _stale_setup(rank, policy, **kwargs):
    m = _Sum(staleness_policy=policy, **kwargs)
    m.update(_t(1.0 + rank))  # the snapshot's accumulation: 1 + rank
    m.sync(blocking=False)
    m.update(_t(10.0))  # a post-snapshot delta on every rank
    return m


def test_staleness_snapshot_serves_consistent_cut(lockstep):
    def body(rank):
        m = _stale_setup(rank, "snapshot")
        m.sync()
        synced = float(m.total)
        m.unsync()
        assert m.sync_stats()["stale_resolves"] == 1
        return synced, float(m.total)

    for rank, (synced, local) in enumerate(lockstep.run(body)):
        assert synced == 3.0  # (1 + 0) + (1 + 1): the snapshot cut
        assert local == 1.0 + rank + 10.0  # the full accumulation


def test_staleness_merge_folds_local_delta(lockstep):
    def body(rank):
        m = _stale_setup(rank, "merge")
        m.sync()
        synced = float(m.total)
        m.unsync()
        return synced, float(m.total)

    for rank, (synced, local) in enumerate(lockstep.run(body)):
        assert synced == 3.0 + 10.0  # the world cut and THIS rank's delta
        assert local == 11.0 + rank


def test_staleness_fresh_raises_typed_and_degrades(lockstep):
    def body(rank):
        m = _stale_setup(rank, "fresh")
        with pytest.raises(StaleSyncError):
            m.sync()
        assert float(m.total) == 11.0 + rank  # restored before the raise
        m2 = _stale_setup(rank, "fresh", sync_on_error="local")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m2.sync()
        assert not m2._is_synced and m2._sync_degraded
        assert m2.sync_stats()["degraded"] == 1
        assert float(m2.total) == 11.0 + rank
        m2.unsync()  # a no-op after a degradation
        return True

    assert all(lockstep.run(body))


# ---------------------------------------------------------------------------
# epochs, cancel and the pipeline
# ---------------------------------------------------------------------------


def test_epoch_skew_raises_symmetrically(lockstep):
    """Rank 0 resolves round 1 while rank 1 syncs blocking (epoch 0): the
    header's sync_epoch column raises on BOTH ranks."""

    def body(rank):
        m = _Sum()
        m.update(_t(1.0 + rank))
        if rank == 0:
            m.sync(blocking=False)
            with pytest.raises(StateDivergenceError, match="sync-round skew"):
                m.sync()
            return "resolved-skew"
        with pytest.raises(StateDivergenceError, match="sync-round skew"):
            m.sync()
        return "blocking-skew"

    assert lockstep.run(body) == ["resolved-skew", "blocking-skew"]


def test_unsync_mid_flight_cancels_by_draining(lockstep):
    def body(rank):
        m = _Sum()
        m.update(_t(2.0 + rank))
        m.sync(blocking=False)
        m.update(_t(5.0))  # a delta while the round flies
        m.unsync()  # cancel: drain and fold back
        assert m.__dict__.get("_inflight") is None
        stats = m.sync_stats()
        assert stats["cancelled"] == 1 and stats["resolved"] == 0
        local = float(m.total)
        m.sync()  # the channel stayed healthy
        world_total = float(m.total)
        m.unsync()
        return local, world_total

    for rank, (local, world_total) in enumerate(lockstep.run(body)):
        assert local == 7.0 + rank
        assert world_total == 7.0 + 8.0


def test_overlap_pipeline_compute_every_n(lockstep):
    """sync_mode="overlap": compute() serves the previous interval's world
    value (the first: the local one) while the next round rides behind."""
    K = 3

    def body(rank):
        m = _Sum(sync_mode="overlap")
        values = []
        for _interval in range(3):
            for _ in range(K):
                m.update(_t(float(rank + 1)))
            values.append(float(m.compute()))
            m._computed = None
        stats = m.sync_stats()
        m.unsync()  # drain the tail round
        return values, stats

    for rank, (values, stats) in enumerate(lockstep.run(body)):
        assert values[0] == rank + 1.0  # no round resolved yet: local
        assert values[1] == 1.5 and values[2] == 1.5  # the previous world cut
        assert stats["launched"] == 3 and stats["resolved"] == 2 and stats["served_local"] == 1


def test_collection_overlap_pipeline(lockstep):
    K = 2

    def body(rank):
        mc = MetricCollection({"a": _Sum(), "b": _Sum()}, sync_mode="overlap")
        values = []
        for _interval in range(3):
            for _ in range(K):
                mc.update(_t(float(rank + 1)))
            values.append({k: float(v) for k, v in mc.compute().items()})
            for m in mc.values():
                m._computed = None
        assert all(not m._is_synced for m in mc.values())
        mc.unsync()  # drain the tail round
        stats = mc.sync_stats()["collection"]
        assert stats["launched"] == 3 and stats["resolved"] == 2 and stats["served_local"] == 1
        return values

    for rank, values in enumerate(lockstep.run(body)):
        assert values[0]["a"] == rank + 1.0
        assert values[1]["a"] == 1.5 and values[2]["a"] == 1.5


def test_member_read_resolves_collection_round(lockstep):
    def body(rank):
        mc = MetricCollection({"a": _Sum(), "b": _Sum()})
        mc.update(_t(1.0 + rank))
        mc.sync(blocking=False)
        val = float(mc["a"].compute())  # one member's read resolves the whole round
        assert mc.__dict__["_inflight_round"] is None
        assert mc["b"]._is_synced  # the sibling left synced (all or nothing)
        mc.unsync()
        assert not mc["b"]._is_synced
        return val

    assert lockstep.run(body) == [1.5, 1.5]


def test_member_reset_cancels_collection_round(lockstep):
    def body(rank):
        mc = MetricCollection({"a": _Sum(), "b": _Sum()})
        mc.update(_t(1.0 + rank))
        mc.sync(blocking=False)
        mc["a"].reset()
        assert mc.__dict__["_inflight_round"] is None
        assert mc.sync_stats()["collection"]["cancelled"] == 1
        return float(mc["a"].total), float(mc["b"].total)

    for rank, (a_local, b_local) in enumerate(lockstep.run(body)):
        assert a_local == 0.0 and b_local == 1.0 + rank


def test_collection_serve_local_caches_are_delta_buffers(lockstep):
    """The pipeline's first read serves the snapshot, but every member's
    unsync cache (group siblings too) holds the fresh delta state."""
    preds = [torch.from_numpy(np.random.RandomState(13 + r).rand(16, 5).astype(np.float32)) for r in range(WORLD)]
    target = [torch.from_numpy(np.random.RandomState(17 + r).randint(0, 5, (16,))) for r in range(WORLD)]

    def body(rank):
        mc = _pr_collection(sync_mode="overlap")
        mc.update(preds[rank], target[rank])
        assert mc.compute_group_keys
        mc.sync()  # the overlap pipeline: launch and serve local
        for m in mc.values():
            for name, v in m.init_state().items():
                assert torch.equal(m._cache[name], v), name
        mc.unsync()  # back on the (empty) delta state
        for m in mc.values():
            for name, v in m.init_state().items():
                assert torch.equal(m._state[name], v), name
        mc.unsync()  # cancel the round: the accumulation folds back
        return float(sum(m._state["tp"].sum() for m in mc.values()))

    assert all(t > 0 for t in lockstep.run(body))


def test_collection_deepcopy_and_pickle_drain_inflight_round(lockstep):
    def body(rank):
        mc = MetricCollection({"a": _Sum(), "b": _Sum()})
        mc.update(_t(1.0 + rank))
        mc.sync(blocking=False)
        clone = copy.deepcopy(mc)  # drains on both ranks
        assert mc.__dict__["_inflight_round"] is None
        mc.update(_t(1.0))
        mc.sync(blocking=False)
        restored = pickle.loads(pickle.dumps(mc))
        return float(clone["a"].total), float(restored["a"].total)

    for rank, (cloned, restored) in enumerate(lockstep.run(body)):
        assert cloned == 1.0 + rank and restored == 2.0 + rank


def test_member_clone_under_collection_round_keeps_accumulation(lockstep):
    def body(rank):
        mc = MetricCollection({"a": _Sum(), "b": _Sum()})
        mc.update(_t(5.0 + rank))
        mc.sync(blocking=False)
        mc.update(_t(7.0))  # a delta while the round flies
        clone = copy.deepcopy(mc["a"])
        assert mc.__dict__["_inflight_round"] is None  # drained
        return float(clone.total), float(mc["a"].total)

    for rank, (cloned, live) in enumerate(lockstep.run(body)):
        assert cloned == 12.0 + rank and live == 12.0 + rank  # snapshot and delta


def test_plan_cache_reused_across_rounds(lockstep):
    def body(rank):
        m = _Sum()
        for i in range(3):
            m.update(_t(1.0 + rank + i))
            m.sync(blocking=False)
            m.sync()
            m.unsync()
        return True

    assert all(lockstep.run(body))
    info = sync_plan_cache_info()
    assert info["misses"] == 1 and info["hits"] >= 4  # one plan, the lanes hit it


# ---------------------------------------------------------------------------
# checkpoints, compiled updates, state_dict, reset, refusal
# ---------------------------------------------------------------------------


def test_checkpoint_refuses_in_flight_round(lockstep, tmp_path):
    from metrics_tpu_torch.core.checkpoint import save_checkpoint

    def body(rank):
        m = _Sum()
        m.update(_t(1.0 + rank))
        m.sync(blocking=False)
        with pytest.raises(MetricsTPUUserError, match="in flight"):
            save_checkpoint(m, str(tmp_path / f"ck{rank}"), rank=rank, world=WORLD, step=0)
        assert m.telemetry()["checkpoint"]["refused"] == 1
        m.unsync()  # cancel; the snapshot is legal again
        return bool(save_checkpoint(m, str(tmp_path / f"ck{rank}"), rank=rank, world=WORLD, step=0))

    assert all(lockstep.run(body))


def test_compiled_updates_ride_the_overlap_window(lockstep):
    """The launch clears the donation latch, so compiled updates in the
    window never write into the snapshot the lane reads."""

    def body(rank):
        over, block = _Sum(compiled_update=True), _Sum(compiled_update=True)
        for i in range(3):
            x = _t(1.0 + rank + i)
            over.update(x)
            block.update(x)
        over.sync(blocking=False)
        for m in (over, block):
            m.update(_t(2.0 * rank + 3))
        block.sync()
        over.staleness_policy = "merge"  # fold the delta: the data block syncs
        over.sync()
        bits = (_state_bytes(over), _state_bytes(block))
        over.unsync()
        block.unsync()
        assert over.compile_stats()["dispatches"] > 0  # the path engaged
        return bits, _state_bytes(over), _state_bytes(block)

    for (_synced_o, _synced_b), local_o, local_b in lockstep.run(body):
        assert local_o == local_b


def test_state_dict_resolves_in_flight_round(lockstep):
    def body(rank):
        m = _Sum()
        m.persistent(True)
        m.update(_t(1.0 + rank))
        m.sync(blocking=False)
        snap = m.state_dict()  # resolves: the snapshot is the synced view
        assert m._is_synced
        m.unsync()
        return float(snap["total"]), float(m.total)

    for rank, (synced_total, local_total) in enumerate(lockstep.run(body)):
        assert synced_total == 3.0 and local_total == 1.0 + rank


def test_reset_drains_in_flight_round(lockstep):
    def body(rank):
        m = _Sum()
        m.update(_t(1.0 + rank))
        m.sync(blocking=False)
        m.reset()
        assert m.__dict__.get("_inflight") is None
        assert m.sync_stats()["cancelled"] == 1
        return float(m.total) == 0.0

    assert all(lockstep.run(body))


def test_overlap_refused_for_non_mergeable_state(lockstep):
    class _NoMerge(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("v", torch.zeros(()), dist_reduce_fx="mean")

        def update(self, x):
            self.v = (self.v + torch.mean(x)) / 2.0

        def compute(self):
            return self.v

    def body(rank):
        m = _NoMerge()
        m.update(_t(1.0))
        with pytest.raises(MetricsTPUUserError, match="merge"):
            m.sync(blocking=False)
        return True

    assert all(lockstep.run(body))


# ---------------------------------------------------------------------------
# the telemetry of one call sequence, against the JAX package
# ---------------------------------------------------------------------------

_SYNC_KEYS = ("launched", "resolved", "stale_resolves", "cancelled", "served_local", "degraded")


def _plan_view(tele_per_rank):
    """The plan counters that do not depend on thread timing: the thread
    ranks share one store, so which rank builds a plan and which hits it is
    a race in both packages. Per rank the lookups (builds + hits) and the
    whole steps, over the ranks the builds."""
    per_rank = [(t["plan"]["builds"] + t["plan"]["cache_hits"], t["plan"]["fused_steps"]) for t in tele_per_rank]
    return per_rank, sum(t["plan"]["builds"] for t in tele_per_rank)


def _sequence(pkg_metric, pkg_collection, t, rank):
    """Blocking syncs, rounds launched and resolved stale and fresh, a
    cancel, the overlap pipeline, a collection round and whole steps."""
    m = pkg_metric(sync_timeout=0)
    m.update(t(1.0 + rank))
    m.sync()
    m.unsync()
    m.sync(blocking=False)
    m.update(t(2.0))
    m.sync()  # stale resolve
    m.unsync()
    m.sync(blocking=False)
    m.unsync()  # cancel
    m.sync_mode = "overlap"
    for _ in range(3):
        m.update(t(1.0))
        m.compute()
        m._computed = None
    m.unsync()
    st = m.init_state()
    for _ in range(2):
        st, _v = m.compiled_step(st, t(3.0))
    mc = pkg_collection({"a": pkg_metric(sync_timeout=0), "b": pkg_metric(sync_timeout=0)})
    mc.update(t(1.0 + rank))
    mc.sync(blocking=False)
    mc.compute()
    return m.telemetry(), mc.telemetry()


def test_sync_and_plan_telemetry_match_the_jax_package(lockstep, monkeypatch):
    import jax
    import jax.numpy as jnp

    import metrics_tpu as ref
    import metrics_tpu.parallel.async_sync as ref_async
    import metrics_tpu.parallel.sync as ref_sync
    from metrics_tpu.core import plan as ref_plan
    from tests.helpers.fake_world import LockstepWorld

    class _RefSum(ref.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", jnp.zeros(()), dist_reduce_fx="sum")
            self.add_state("count", jnp.zeros((), jnp.int32), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + jnp.sum(x)
            self.count = self.count + jnp.asarray(jnp.size(x), jnp.int32)

        def compute(self):
            return self.total / self.count

    from metrics_tpu.observability import journal as ref_journal
    from metrics_tpu_torch.observability import journal

    journals = (journal, ref_journal)
    for j in journals:
        j.clear()
        j.enable()
    try:
        port_out = lockstep.run(lambda rank: _sequence(_Sum, MetricCollection, _t, rank))
        port_events = [e.kind for e in journal.events()]
    finally:
        journal.disable()
    ref_world = LockstepWorld(WORLD)
    monkeypatch.setattr(jax, "process_count", lambda: ref_world.world)
    monkeypatch.setattr(ref_sync, "_raw_process_allgather", ref_world.allgather)
    monkeypatch.setattr(ref_async, "_get_executor", ref_world.executor_for_current_rank)
    monkeypatch.setattr(ref_async, "_current_domain", ref_world.rank_domain)
    ref_plan.clear_plans()
    try:
        ref_out = ref_world.run(
            lambda rank: _sequence(_RefSum, ref.MetricCollection, lambda *x: jnp.asarray(x, jnp.float32), rank))
        ref_events = [e.kind for e in ref_journal.events()]
    finally:
        ref_world.shutdown_executors()
        ref_plan.clear_plans()
        for j in journals:
            j.disable()
            j.clear()
    # the journal's round and plan events, counted over both ranks
    for kinds in (("sync.launch",), ("sync.resolve",), ("sync.drain",), ("plan.fused_step",),
                  ("plan.build", "plan.hit")):
        got, want = sum(k in kinds for k in port_events), sum(k in kinds for k in ref_events)
        assert got == want and want > 0, (kinds, got, want)
    for (pm, pc), (rm, rc) in zip(port_out, ref_out):
        for got, want in ((pm, rm), (pc["collection"], rc["collection"])):
            assert {k: got["sync"][k] for k in _SYNC_KEYS} == {k: want["sync"][k] for k in _SYNC_KEYS}
    for pick in (lambda out: [m for m, _c in out], lambda out: [c["collection"] for _m, c in out]):
        assert _plan_view(pick(port_out)) == _plan_view(pick(ref_out))
    assert port_out[0][0]["sync"]["resolved"] == 3 and port_out[0][0]["plan"]["fused_steps"] == 2
    assert plan_mod.plan_cache_info()["size"] >= 1
