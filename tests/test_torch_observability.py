"""The port's telemetry against the JAX package's.

Case for case with ``tests/observability/*``, on the CPU:

- the journal: recording, the catalog (the JAX package's kinds), filters,
  the ring's wrap, per-thread rings, the rank seam, subscribers, the
  refusal inside a CUDA graph capture;
- ``warn_once``'s dedupe keys, the rank gate and ``diag``; the compute-group
  static hazard warns once per class under ``("group-static-hazard", cls)``;
- the disabled recorder: no ``record`` call at all (counted, not timed)
  through syncs, degradations, checkpoints and compute groups, and no
  allocation inside the observability package on the step path;
- the Chrome-trace exporter: the same trace as the JAX package's for the
  same events, lanes, re-basing, a real two-rank run;
- ``telemetry()``: the JAX package's keys, deltas, the views, the
  checkpoint/health/process counters, JSON-lines and Prometheus (the same
  text as the JAX encoders' for the same snapshot), pickling;
- two ranks on threads (``tests/helpers/torch_world.py`` for the port,
  ``tests/helpers/fake_world.py`` for the JAX package, the rank provider
  installed in the test): after the same updates, syncs, a divergence and
  a save/load, ``telemetry()`` equals the JAX package's key for key, the
  sync/checkpoint/health/process counters by value, and each rank's
  ``(kind, label)`` journal equals the JAX package's once ``compiled.*`` and
  ``plan.*`` are filtered out. ``sync.plan`` is compared in total over the
  ranks, not per rank: the thread ranks share one plan cache in both
  packages, so which rank records the one build is the harness's choice.
  The ``compile`` and ``plan`` domains stay at their defaults until the
  port has the compiled path and the execution plan, so only their keys
  are compared.
"""
import copy
import json
import os
import pickle
import threading
import tracemalloc
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.parallel.sync as ref_sync
import metrics_tpu_torch as port
from metrics_tpu.observability import journal as ref_journal
from metrics_tpu.observability import registry as ref_registry
from metrics_tpu.observability import trace_export as ref_trace
from metrics_tpu.parallel import health as ref_health
from metrics_tpu.parallel.bucketing import clear_sync_plan_cache as ref_clear_plans
from metrics_tpu_torch import observability as obs
from metrics_tpu_torch.core import collections as port_collections
from metrics_tpu_torch.observability import diagnostics, journal, registry, trace_export
from metrics_tpu_torch.parallel import health
from metrics_tpu_torch.parallel.bucketing import clear_sync_plan_cache
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, SyncError
from tests.helpers.fake_world import LockstepWorld
from tests.helpers.torch_world import TorchLockstepWorld

WORLD = 2
OBS_DIR = os.path.dirname(obs.__file__)


def _reset_journal(j):
    j.disable()
    j.clear()
    j._subscribers.clear()
    j._refresh_active()
    j.set_rank_provider(None)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both journals off and empty, zeroed process counters in both
    packages, no dedupe memory, healthy channels, empty plan caches."""
    for j in (journal, ref_journal):
        _reset_journal(j)
    for reg in (registry, ref_registry):
        monkeypatch.setattr(reg, "PROCESS", {k: 0.0 if isinstance(v, float) else 0 for k, v in reg.PROCESS.items()})
    diagnostics.reset()
    clear_sync_plan_cache()
    ref_clear_plans()
    yield
    for j in (journal, ref_journal):
        _reset_journal(j)
    diagnostics.reset()
    health.reset_channel_health()
    ref_health.reset_channel_health()


class _Sum(port.Metric):
    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum", persistent=True)

    def update(self, x):
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class _RefSum(ref.Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", jnp.zeros(()), dist_reduce_fx="sum", persistent=True)

    def update(self, x):
        self.total = self.total + jnp.sum(x)

    def compute(self):
        return self.total


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


# ---- the journal (tests/observability/test_journal.py) ----------------------


def test_disabled_recorder_records_nothing():
    journal.record("sync.gather", label="m")
    assert journal.events() == [] and journal.ACTIVE is False


def test_enable_record_clear():
    journal.enable()
    journal.record("sync.gather", label="m", sync_epoch=3)
    journal.record("checkpoint.save", label="m", step=7)
    evs = journal.events()
    assert [e.kind for e in evs] == ["sync.gather", "checkpoint.save"]
    assert evs[0].fields["sync_epoch"] == 3 and evs[1].step == 7 and evs[0].ts <= evs[1].ts
    journal.clear()
    assert journal.events() == []


def test_every_kind_is_catalogued_as_the_reference():
    assert journal.EVENT_KINDS == ref_journal.EVENT_KINDS
    journal.enable()
    for kind in journal.EVENT_KINDS:
        journal.record(kind, label="x")
    assert len(journal.events()) == len(journal.EVENT_KINDS)


def test_kind_and_class_filtering():
    journal.enable()
    journal.record("sync.launch", sync_epoch=1)
    journal.record("sync.resolve", sync_epoch=1)
    journal.record("health.watchdog")
    assert [e.kind for e in journal.events(kinds=("sync",))] == ["sync.launch", "sync.resolve"]
    assert [e.kind for e in journal.events(kinds=("health.watchdog",))] == ["health.watchdog"]


def test_ring_overwrites_oldest():
    journal.enable(capacity=8)
    try:
        for i in range(20):
            journal.record("sync.gather", step=i)
        assert [e.step for e in journal.events()] == list(range(12, 20))
    finally:
        journal.enable(capacity=journal._DEFAULT_CAPACITY)
        journal.clear()


def test_threads_record_into_their_own_rings_and_merge_sorted():
    journal.enable()

    def emit(tag):
        for i in range(5):
            journal.record("sync.gather", label=tag, step=i)

    threads = [threading.Thread(target=emit, args=(f"t{i}",)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    emit("main")
    evs = journal.events()
    assert len(evs) == 20 and all(evs[i].ts <= evs[i + 1].ts for i in range(19))
    assert {e.label for e in evs} == {"t0", "t1", "t2", "main"}


def test_rank_provider_seam_and_default(monkeypatch):
    journal.enable()
    journal.record("sync.gather")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 3)
    journal.record("sync.gather")
    assert [e.rank for e in journal.events()] == [0, 3]
    journal.set_rank_provider(lambda: 7)
    journal.record("sync.gather")
    assert len(journal.events(rank=7)) == 1 and journal.events(rank=5) == []


def test_subscriber_receives_without_recorder():
    got = []
    sub = journal.on_event(got.append, classes=("degrade", "health"))
    try:
        assert journal.ACTIVE is True
        journal.record("degrade.local", label="m", error="SyncError")
        journal.record("sync.gather", label="m")
        journal.record("health.watchdog")
        assert [e.kind for e in got] == ["degrade.local", "health.watchdog"]
        assert journal.events() == []
    finally:
        sub.close()
    assert journal.ACTIVE is False
    journal.record("degrade.local")
    assert got[-1].kind == "health.watchdog"


def test_subscriber_exceptions_never_propagate():
    def boom(ev):
        raise RuntimeError("fleet logger died")

    with journal.on_event(boom):
        journal.record("health.watchdog")


def test_record_inside_a_graph_capture_raises(monkeypatch):
    journal.enable()
    monkeypatch.setattr(journal, "_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA graph is being captured"):
        journal.record("sync.gather", label="m")


def test_event_as_dict_and_sequence():
    journal.enable()
    journal.record("sync.resolve", label="m", step=2, sync_epoch=4, stale=False)
    d = journal.events()[0].as_dict()
    assert d["kind"] == "sync.resolve" and d["sync_epoch"] == 4
    assert set(d) >= {"ts", "rank", "step", "kind", "label"}
    assert journal.event_sequence() == [("sync.resolve", "m")]


# ---- diagnostics (tests/observability/test_diagnostics.py) ------------------


def _caught(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        emitted = fn()
    return emitted, caught


def test_warn_once_dedupes_on_the_key():
    emitted1, caught1 = _caught(lambda: diagnostics.warn_once(("k", 1), "first"))
    emitted2, caught2 = _caught(lambda: diagnostics.warn_once(("k", 1), "second"))
    assert emitted1 is True and len(caught1) == 1 and "first" in str(caught1[0].message)
    assert emitted2 is False and caught2 == []
    assert diagnostics.seen(("k", 1))


def test_different_keys_warn_independently():
    e1, c1 = _caught(lambda: diagnostics.warn_once(("k", 1), "one"))
    e2, c2 = _caught(lambda: diagnostics.warn_once(("k", 2), "two"))
    assert e1 and e2 and len(c1) == len(c2) == 1


def test_key_is_any_hashable_tuple():
    assert diagnostics.warn_once(("group-static-hazard", int), "m1")
    assert diagnostics.warn_once(("group-static-hazard", float), "m2")
    assert not diagnostics.warn_once(("group-static-hazard", int), "m1 again")


def test_reset_single_key():
    diagnostics.warn_once("a", "x")
    diagnostics.warn_once("b", "x")
    diagnostics.reset("a")
    assert not diagnostics.seen("a") and diagnostics.seen("b")


def test_category_passes_through():
    _, caught = _caught(lambda: diagnostics.warn_once("cat-key", "msg", RuntimeWarning))
    assert caught and issubclass(caught[0].category, RuntimeWarning)


def test_every_rank_warns_off_rank_zero(monkeypatch):
    import metrics_tpu_torch.utils.prints as prints

    monkeypatch.setattr(prints, "_rank", lambda: 3)
    emitted, caught = _caught(lambda: diagnostics.warn_once("rz", "gated"))
    assert emitted is True and caught == []
    emitted, caught = _caught(lambda: diagnostics.warn_once("er", "loud", every_rank=True))
    assert emitted and len(caught) == 1


def test_group_static_hazard_warns_once_per_class(monkeypatch):
    """The consumer: the planner's hazard warning is keyed per class."""
    monkeypatch.setattr(port_collections, "_static_grouping_hazards",
                        lambda m: ["update latches `mode`"] if isinstance(m, port.Precision) else [])

    def collection():
        return port.MetricCollection({k: c(num_classes=3, device="cpu") for k, c in
                                      (("p1", port.Precision), ("p2", port.Precision), ("r", port.Recall))})

    _, caught = _caught(lambda: [collection().compute_group_keys for _ in range(2)])
    hazards = [c for c in caught if "excluded from compute groups" in str(c.message)]
    assert len(hazards) == 1 and "Precision" in str(hazards[0].message)
    assert diagnostics.seen(("group-static-hazard", port.Precision))
    assert collection().compute_group_keys == []  # Precision stays solo; one Recall has no sibling


def test_diag_emits_one_json_line(capsys):
    diagnostics.diag(config=13, note="hello", value=1.5)
    assert json.loads(capsys.readouterr().err.strip()) == {"diagnostic": {"config": 13, "note": "hello", "value": 1.5}}


# ---- the disabled recorder (tests/observability/test_disabled_overhead.py) --


def _world_workload(world, tmp_path):
    """Every emission site of the port on two thread ranks: compute groups
    form and detach, a fused collection sync (and its plan), metric syncs, a
    degraded sync, checkpoint save/prune/load/auto-snapshot, a guarded
    collective."""

    def body(rank):
        mc = port.MetricCollection({"p": port.Precision(num_classes=3, device="cpu"),
                                    "r": port.Recall(num_classes=3, device="cpu")})
        for step in range(2):
            mc(torch.tensor([0, 1, 2, rank]), torch.tensor([0, 2, 1, step]))
        mc.sync()
        mc.unsync()
        m = _Sum()
        m.update(torch.ones(3))
        m.compute()
        dv = _Sum(sync_on_error="local")
        dv.sync_strict_update_count = True
        for _ in range(rank + 1):
            dv.update(torch.ones(2))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dv.sync()
        d = str(tmp_path / f"r{rank}")
        with m.checkpointer(d, keep_last=1):
            m.update(torch.ones(1))
            m.update(torch.ones(1))
        port.load_checkpoint(_Sum(), d, rank=0, world=1)
        mc["p"].update(torch.tensor([1]), torch.tensor([1]))  # leaves its group
        health.call_with_sync_watchdog(lambda: None, timeout=30)
        return True

    return world.run(body)


def test_disabled_recorder_never_calls_record(monkeypatch, tmp_path):
    calls = []
    real = journal.record

    def counting(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(journal, "record", counting)
    world = TorchLockstepWorld(WORLD).install(monkeypatch)
    _world_workload(world, tmp_path / "off")
    assert calls == [] and journal.events() == []
    # the control: the same workload with the recorder on records every class
    journal.set_rank_provider(lambda: world._rank.value)
    journal.enable()
    _world_workload(world, tmp_path / "on")
    # plan.* comes from the plan store the syncs consult, as in the JAX package
    assert {k.partition(".")[0] for k in calls} == {"group", "sync", "health", "degrade", "checkpoint", "plan"}
    assert len(calls) == len(journal.events())


def test_disabled_step_path_allocates_nothing_in_observability():
    mc = port.MetricCollection({"p": port.Precision(num_classes=3, device="cpu"),
                                "r": port.Recall(num_classes=3, device="cpu"),
                                "a": port.Accuracy(num_classes=3, device="cpu")})
    m = _Sum()
    # as the JAX twin (tests/observability/test_disabled_overhead.py): the
    # compiled path engages in the warm-up, and the window is its steady state
    for metric in (*mc.values(), m):
        metric.compiled_update = True
    x, y = torch.tensor([0, 1, 2, 1]), torch.tensor([0, 2, 1, 1])
    for _ in range(3):
        mc.update(x, y)
        m(torch.ones(2))
    tracemalloc.start(25)
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(50):
            mc.update(x, y)
            m(torch.ones(2))
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert journal.events() == []
    assert m.compile_stats()["dispatches"] == 53  # the compiled path ran
    grown = [s for s in after.compare_to(before, "filename")
             if s.size_diff > 0 and any(f.filename.startswith(OBS_DIR) for f in s.traceback)]
    assert grown == [], [(s.traceback[0].filename, s.size_diff) for s in grown]


# ---- the Chrome-trace exporter (tests/observability/test_trace_export.py) ---

_SYNTHETIC = [
    (10.000, 0, "compiled.dispatch", "Sum", 1, dict(op="update", dur_s=0.002)),
    (10.010, 0, "compiled.trace", "Sum", 1, dict(op="update", traces=1)),
    (10.020, 1, "sync.launch", "Sum", -1, dict(sync_epoch=3, update_count=5)),
    (10.120, 1, "sync.resolve", "Sum", -1, dict(sync_epoch=3, stale=False, verdict="fresh", wait_s=0.0001,
                                                 gather_s=0.05, gather_start=10.021)),
    (10.130, 0, "sync.hop", "intra", -1, dict(tier=0, dur_s=0.001)),
    (10.140, 0, "sync.gather", "MetricCollection[a, b]", -1, dict(sync_epoch=0, states=4, fused=None)),
    (10.150, 1, "health.failure", "Accuracy", 2, dict(error="StateDivergenceError", on_error="local")),
    (10.160, 1, "health.margin", "all_gather", -1, dict(elapsed_s=0.01, timeout_s=600.0, margin_s=599.99)),
    (10.170, 0, "checkpoint.save", "Accuracy", 0, dict(rank=0, world=2, bytes=64)),
    (10.180, 0, "group.form", "Precision", -1, dict(members=2, keys="p,r")),
    (10.190, 0, "resilience.quorum", "", -1, dict(survivors=(0,))),
]


def test_trace_equals_the_reference_for_the_same_events():
    got = trace_export.chrome_trace([journal.Event(ts, r, s, k, lab, f) for ts, r, k, lab, s, f in _SYNTHETIC])
    want = ref_trace.chrome_trace([ref_journal.Event(ts, r, s, k, lab, f) for ts, r, k, lab, s, f in _SYNTHETIC])
    assert got == want
    assert trace_export.chrome_trace([]) == {"traceEvents": [], "displayTimeUnit": "ms"}


def test_overlapped_round_renders_background_lane_with_epoch():
    evs = []
    for rank in (0, 1):
        evs.append(journal.Event(100.0, rank, -1, "sync.launch", "Sum", dict(sync_epoch=3)))
        evs.append(journal.Event(100.002 + rank * 1e-4, rank, -1, "compiled.dispatch", "Sum", dict(dur_s=0.001)))
        evs.append(journal.Event(100.1, rank, -1, "sync.resolve", "Sum",
                                 dict(sync_epoch=3, wait_s=0.0001, gather_s=0.05, gather_start=100.001)))
    trace = trace_export.chrome_trace(evs)["traceEvents"]
    gathers = [t for t in trace if t["ph"] == "X" and t["tid"] == trace_export.SYNC_LANE]
    assert {t["pid"] for t in gathers} == {0, 1}
    assert all(t["args"]["sync_epoch"] == 3 and abs(t["dur"] - 50_000.0) < 1e-3 for t in gathers)
    assert any(t["ph"] == "s" and t["id"] == 3 for t in trace) and any(t["ph"] == "f" and t["id"] == 3 for t in trace)
    assert all(t["ts"] >= 0 for t in trace if t["ph"] != "M")


def test_lane_metadata_present_per_rank():
    trace = trace_export.chrome_trace([journal.Event(1.0, 2, -1, "health.watchdog", "", {})])
    names = {(t["pid"], t.get("args", {}).get("name")) for t in trace["traceEvents"] if t["ph"] == "M"}
    assert {(2, "rank 2"), (2, "step"), (2, "sync-background")} <= names


def test_export_writes_loadable_json(tmp_path):
    journal.enable()
    journal.record("sync.gather", label="m", sync_epoch=0)
    journal.record("health.watchdog", label="all_gather", timeout_s=5)
    path = tmp_path / "trace.json"
    trace = obs.export_chrome_trace(str(path))
    loaded = json.loads(path.read_text())
    assert loaded["traceEvents"] == json.loads(json.dumps(trace))["traceEvents"]
    assert all("ph" in t and "pid" in t and ("ts" in t or t["ph"] == "M") for t in loaded["traceEvents"])


def test_two_rank_run_exports_one_process_per_rank(monkeypatch, tmp_path):
    world = TorchLockstepWorld(WORLD).install(monkeypatch)
    journal.set_rank_provider(lambda: world._rank.value)
    journal.enable()
    _world_workload(world, tmp_path)
    trace = obs.export_chrome_trace(str(tmp_path / "t.json"))["traceEvents"]
    assert {t["pid"] for t in trace} == {0, 1}
    assert min(t["ts"] for t in trace if t["ph"] != "M") == 0.0
    assert all(t["ts"] >= 0 for t in trace if t["ph"] != "M")


# ---- telemetry() (tests/observability/test_telemetry.py) ---------------------


def test_telemetry_has_every_domain_with_the_reference_keys():
    m, r = _Sum(), _RefSum()
    m.update(torch.ones(3))
    r.update(jnp.ones((3,)))
    t, want = m.telemetry(), r.telemetry()
    assert t["schema"] == "metrics_tpu.telemetry.v1" == obs.TELEMETRY_SCHEMA and t["label"] == "_Sum"
    assert _keys(t) == _keys(want)
    assert t["compile"] == want["compile"] == {"traces": 0, "dispatches": 0, "cache_hits": 0, "steps_seen": 1,
                                                "fallback": None}
    assert t["sync"] == registry.DOMAIN_DEFAULTS["sync"] and t["checkpoint"]["saves"] == 0
    assert t["health"]["sync_failures"] == 0 and t["process"]["channel_suspect"] is False


def test_compile_and_sync_stats_are_views_over_the_registry():
    m = _Sum()
    reg = registry.registry_of(m)
    reg.domain("sync")["launched"] = 5
    reg.domain("compile")["dispatches"] = 3
    assert m.sync_stats()["launched"] == 5 and m.telemetry()["sync"]["launched"] == 5
    assert m.compile_stats()["dispatches"] == 3 and m.compile_stats()["cache_hits"] == 3


def test_telemetry_delta():
    m = _Sum()
    reg = registry.registry_of(m)
    reg.inc("checkpoint", "saves")
    assert m.telemetry(delta=True)["checkpoint"]["saves"] == 1  # the first delta is against zero
    reg.inc("checkpoint", "saves", by=2)
    d = m.telemetry(delta=True)
    assert d["checkpoint"]["saves"] == 2 and d["sync"]["launched"] == 0 and d["label"] == "_Sum"
    assert m.telemetry(delta=True)["checkpoint"]["saves"] == 0


def _checkpoint_run(pkg, make, ones, directory):
    m = make()
    m.update(ones(4))
    pkg.save_checkpoint(m, directory, step=0, rank=0, world=1)
    pkg.save_checkpoint(m, directory, step=1, rank=0, world=1, keep_last=1)
    with m.checkpointer(directory, every_n_updates=2):
        for _ in range(3):
            m.update(ones(1))
    m2 = make()
    pkg.load_checkpoint(m2, directory, rank=0, world=1)
    return m, m2


def test_checkpoint_counters_and_events_match_the_reference(tmp_path):
    for j in (journal, ref_journal):
        j.enable()
    m, m2 = _checkpoint_run(port, _Sum, torch.ones, str(tmp_path / "port"))
    r, r2 = _checkpoint_run(ref, _RefSum, lambda n: jnp.ones((n,)), str(tmp_path / "ref"))
    assert float(m2.total) == float(np.asarray(r2.total)) == 7.0
    assert m.telemetry()["checkpoint"] == r.telemetry()["checkpoint"]
    assert m.telemetry()["checkpoint"] == {"saves": 4, "loads": 0, "pruned_steps": 1, "refused": 0,
                                           "auto_snapshots": 2}
    assert m2.telemetry()["checkpoint"] == r2.telemetry()["checkpoint"]
    assert m2.telemetry()["checkpoint"]["loads"] == 1
    kinds = [e.kind for e in journal.events(kinds=("checkpoint",))]
    assert kinds == [e.kind for e in ref_journal.events(kinds=("checkpoint",))]
    assert kinds == ["checkpoint.save", "checkpoint.save", "checkpoint.prune", "checkpoint.save", "checkpoint.save",
                     "checkpoint.load"]


def test_checkpoint_refusal_counted(tmp_path):
    journal.enable()
    m = _Sum()
    m.update(torch.ones(4))
    m._is_synced = True
    with pytest.raises(MetricsTPUUserError, match="currently synced"):
        port.save_checkpoint(m, str(tmp_path), rank=0, world=1)
    assert m.telemetry()["checkpoint"]["refused"] == 1
    assert "synced" in journal.events(kinds=("checkpoint.refused",))[0].fields["reason"]


def test_health_counters_on_degradation_match_the_reference():
    port_h, ref_h = _Sum(), _RefSum()
    for m, err in ((port_h, SyncError), (ref_h, ref.utils.exceptions.SyncError)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m._handle_sync_failure(err("peer died"), "local")
        with pytest.raises(err):
            m._handle_sync_failure(err("again"), "raise")
    assert port_h.telemetry()["health"] == ref_h.telemetry()["health"]
    assert port_h.telemetry()["health"] == {"sync_failures": 2, "degraded": 1, "errors": {"SyncError": 2}}


def test_degradation_events_reach_subscribers():
    got = []
    m = _Sum()
    with journal.on_event(got.append, classes=("degrade",)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m._handle_sync_failure(SyncError("peer died"), "warn")
    assert [e.kind for e in got] == ["degrade.local"] and got[0].fields["error"] == "SyncError"


def test_watchdog_counts_fires_and_margins():
    for j in (journal, ref_journal):
        j.enable()
    for h in (health, ref_health):
        assert h.call_with_sync_watchdog(lambda: 5, timeout=30, what="probe") == 5
    margin = registry.process_snapshot()["watchdog_margin_s"]
    assert 0 < margin <= 30 and 0 < ref_registry.process_snapshot()["watchdog_margin_s"] <= 30
    ev = journal.events(kinds=("health.margin",))[0]
    assert ev.label == "probe" and ev.fields["elapsed_s"] >= 0 and ev.fields["margin_s"] == margin
    release = threading.Event()
    for h in (health, ref_health):
        with pytest.raises(Exception, match="did not complete within"):
            h.call_with_sync_watchdog(lambda: release.wait(5), timeout=0.05, what="stuck")
    release.set()
    assert registry.process_snapshot()["watchdog_fired"] == ref_registry.process_snapshot()["watchdog_fired"] == 1
    assert registry.process_snapshot()["channel_suspect"] is True
    assert [e.label for e in journal.events(kinds=("health.watchdog",))] == ["stuck"]
    health.reset_channel_health()
    ref_health.reset_channel_health()
    assert registry.process_snapshot()["channel_suspect"] is False


def test_collection_telemetry_one_call():
    mc = port.MetricCollection({"a": _Sum(), "b": _Sum()})
    mc.update(torch.ones(3))
    t = mc.telemetry()
    assert set(t) == {"collection", "members"} and set(t["members"]) == {"a", "b"}
    for domain in ("compile", "sync", "checkpoint", "health", "plan", "process"):
        assert domain in t["collection"] and all(domain in s for s in t["members"].values())
    assert set(mc.sync_stats()) == set(mc.compile_stats()) == {"collection", "members"}
    rc = ref.MetricCollection({"a": _RefSum(), "b": _RefSum()})
    rc.update(jnp.ones((3,)))
    assert _keys(t) == _keys(rc.telemetry())


def test_encoders_parse_and_equal_the_reference():
    mc = port.MetricCollection({"a": _Sum(), "b": _Sum()})
    mc.update(torch.ones(3))
    registry.registry_of(mc["a"]).count_error(SyncError("x"), degraded=True)
    snap = mc.telemetry()
    rows = [json.loads(line) for line in obs.telemetry_jsonl(snap).splitlines()]
    assert all(r["schema"] == "metrics_tpu.telemetry.v1" for r in rows)
    domains = {(r.get("member"), r["domain"]) for r in rows}
    assert (None, "sync") in domains and ("a", "compile") in domains and ("b", "health") in domains
    text = obs.telemetry_prometheus(snap)
    assert "# TYPE metrics_tpu_checkpoint_saves counter" in text
    assert 'metrics_tpu_health_errors_SyncError{label="_Sum",member="a"} 1' in text
    assert "metrics_tpu_process_channel_suspect" in text and "telemetry.v1" not in text
    for line in text.strip().splitlines():
        assert line.startswith("# TYPE ") or float(line.rsplit(" ", 1)[1]) >= 0
    assert obs.telemetry_jsonl(snap) == ref_registry.telemetry_jsonl(snap)
    assert text == ref_registry.telemetry_prometheus(snap)


def test_registry_survives_pickle_and_deepcopy():
    m = _Sum()
    m.update(torch.ones(3))
    registry.registry_of(m).inc("checkpoint", "saves")
    for clone in (pickle.loads(pickle.dumps(m)), copy.deepcopy(m), m.clone()):
        assert clone.telemetry()["checkpoint"]["saves"] == 1
        registry.registry_of(clone).inc("checkpoint", "saves")
    assert m.telemetry()["checkpoint"]["saves"] == 1


# ---- two ranks (tests/observability/test_lockstep_journal.py) ---------------


@pytest.fixture
def world(monkeypatch):
    w = TorchLockstepWorld(WORLD).install(monkeypatch)
    journal.set_rank_provider(lambda: w._rank.value)
    return w


def _rank_kinds(j, rank, exclude_classes=("compiled", "plan"), exclude=("sync.plan",)):
    return [(e.kind, e.label) for e in j.events(rank=rank)
            if e.kind.partition(".")[0] not in exclude_classes and e.kind not in exclude]


def test_blocking_sync_journals_identically_on_both_ranks(world):
    journal.enable()

    def body(rank):
        m = _Sum()
        m.update(torch.tensor(float(rank + 1)))
        m.sync()
        m.unsync()
        return float(m.total)

    assert world.run(body) == [1.0, 2.0]
    assert _rank_kinds(journal, 0) == _rank_kinds(journal, 1) == [("sync.gather", "_Sum")]
    assert journal.events(kinds=("sync.gather",))[0].fields["sync_epoch"] == 0


def test_degradation_events_are_symmetric(world):
    journal.enable()

    def body(rank):
        m = _Sum(sync_on_error="local")
        m.sync_strict_update_count = True
        for _ in range(rank + 1):
            m.update(torch.tensor(1.0))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m.sync()
        assert m._sync_degraded
        return m.telemetry()["health"]

    healths = world.run(body)
    for rank in (0, 1):
        assert [k for k, _ in _rank_kinds(journal, rank)] == ["sync.gather", "health.failure", "degrade.local"]
    for h in healths:
        assert h == {"sync_failures": 1, "degraded": 1, "errors": {"StateDivergenceError": 1}}


def _data(rank, step):
    rng = np.random.RandomState(100 * rank + step)
    return rng.randint(0, 5, 16), rng.randint(0, 5, 16)


def _scenario(pkg, conv, rank, directory, saved):
    """Updates with a compute group (Precision and Recall), a fused
    collection sync, a metric's sync and compute, a strict update-count
    divergence degraded to local, a save/load of the collection (``saved``:
    a barrier of the ranks), a grouped member's direct update."""
    kw = {} if pkg is ref else {"device": "cpu"}

    def collection():
        return pkg.MetricCollection({"prec": pkg.Precision(num_classes=5, average="macro", **kw),
                                     "rec": pkg.Recall(num_classes=5, average="macro", **kw)})

    mc = collection()
    for s in range(3):
        p, t = _data(rank, s)
        mc(conv(p), conv(t))
    mc.sync()
    mc.unsync()
    m = pkg.MeanSquaredError(**kw)
    for s in range(2):
        p, t = _data(rank, s)
        m.update(conv(p.astype(np.float32)), conv(t.astype(np.float32)))
    m.sync()
    m.unsync()
    m.compute()
    dv = pkg.MeanSquaredError(**kw)
    dv.sync_on_error = "local"
    dv.sync_strict_update_count = True
    for s in range(rank + 1):
        p, t = _data(rank, s)
        dv.update(conv(p.astype(np.float32)), conv(t.astype(np.float32)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dv.sync()
    pkg.save_checkpoint(mc, directory, step=0, rank=rank, world=WORLD)
    saved.wait()
    loaded = collection()
    pkg.load_checkpoint(loaded, directory, rank=rank, world=WORLD)
    p, t = _data(rank, 9)
    mc["prec"].update(conv(p), conv(t))
    return {"mc": mc.telemetry(), "m": m.telemetry(), "dv": dv.telemetry(), "loaded": loaded.telemetry()}


def _assert_counters_equal(got, want, path=""):
    """Key for key everywhere; by value except in the compile and plan
    domains (at their defaults in the port until the compiled path)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            if k in ("compile", "plan"):
                assert set(got[k]) == set(want[k]), (path, k)
            else:
                _assert_counters_equal(got[k], want[k], f"{path}/{k}")
    else:
        assert got == want, (path, got, want)


def test_telemetry_and_journal_equal_the_reference(world, monkeypatch, tmp_path):
    journal.enable()
    saved = threading.Barrier(WORLD)
    got = world.run(lambda rank: _scenario(port, torch.from_numpy, rank, str(tmp_path / "port"), saved))

    ref_world = LockstepWorld(WORLD)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package as the port runs it: no metricslint pass before
        # grouping (ROADMAP.md A11), which also saves its source parse here
        mp.setenv("METRICS_TPU_ANALYSIS_PRECLASSIFY", "0")
        mp.setattr(jax, "process_count", lambda: ref_world.world)
        mp.setattr(ref_sync, "_raw_process_allgather", ref_world.allgather)
        ref_journal.set_rank_provider(lambda: ref_world._rank.value)
        ref_journal.enable()
        want = ref_world.run(lambda rank: _scenario(ref, jnp.asarray, rank, str(tmp_path / "ref"), saved))

    for rank in range(WORLD):
        _assert_counters_equal(got[rank], want[rank])
        assert _rank_kinds(journal, rank) == _rank_kinds(ref_journal, rank)
    assert got[1]["dv"]["health"]["errors"] == {"StateDivergenceError": 1}
    assert got[0]["loaded"]["collection"]["checkpoint"]["loads"] == 1
    assert len(journal.events(kinds=("sync.plan",))) == len(ref_journal.events(kinds=("sync.plan",)))
    assert ("group.form", "Precision") in _rank_kinds(journal, 0)
