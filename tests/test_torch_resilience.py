"""Quorum membership, probation and the adaptive controller, against the JAX package.

Port twin of ``tests/parallel/test_resilience.py``, case for case. The unit
cases run one call sequence on both packages' ``parallel/resilience.py``
(frozen clocks) and compare gates, epochs, counters, journaled events and
controller decisions. The fleet cases run one scenario on the JAX package's
``fake_world.FleetWorld`` and on the port's
``tests/helpers/torch_world.py::TorchFleetWorld`` (thread ranks, each the
real quorum-mode sync) from the same per-rank inputs, and compare the
synced values bit for bit, the membership epochs and live sets, and the
process counters. Then the port's own divergences: quorum with another
process group raises, the in-program sync takes no part in quorum (as the
JAX package's ``psum``), and a rank that missed a membership transition
makes every rank raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.parallel.resilience as ref_res
import metrics_tpu_torch.parallel.resilience as resilience
import metrics_tpu_torch.parallel.sync as sync_mod
from metrics_tpu.core.cat_buffer import CatBuffer as RefCatBuffer
from metrics_tpu.core.metric import Metric as RefMetric
from metrics_tpu.observability import diagnostics as ref_diagnostics
from metrics_tpu.observability import journal as ref_journal
from metrics_tpu.observability.registry import process_snapshot as ref_process_snapshot
from metrics_tpu.parallel.bucketing import clear_sync_plan_cache as ref_clear_plans
from metrics_tpu.parallel.health import get_sync_timeout as ref_get_sync_timeout
from metrics_tpu.parallel.sync import host_sync_state as ref_host_sync_state
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.observability import diagnostics, journal
from metrics_tpu_torch.observability.registry import process_snapshot
from metrics_tpu_torch.parallel.bucketing import clear_sync_plan_cache
from metrics_tpu_torch.parallel.health import DEFAULT_SYNC_TIMEOUT_S, get_sync_timeout
from metrics_tpu_torch.parallel.sync import host_sync_state
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, StateDivergenceError, SyncTimeoutError
from tests.helpers import fake_world
from tests.helpers.torch_world import FaultProfile, TorchFleetWorld, TorchLockstepWorld, state_bits

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

COUNTERS = ("channel_suspect_latched", "channel_resets", "channel_readmits", "membership_transitions",
            "quorum_shrinks", "quorum_readmits")


@pytest.fixture(autouse=True)
def _fresh_resilience():
    saved = dict(resilience._PROBATION), dict(ref_res._PROBATION)
    for res in (resilience, ref_res):
        res.reset_resilience()
    for j in (journal, ref_journal):
        j.clear()
    clear_sync_plan_cache()
    ref_clear_plans()
    yield
    for res, probation in zip((resilience, ref_res), saved):
        res.reset_resilience()
        res._PROBATION.clear()
        res._PROBATION.update(probation)
    clear_sync_plan_cache()
    ref_clear_plans()
    for j in (journal, ref_journal):
        j.disable()
        j.clear()
    for d in (diagnostics, ref_diagnostics):
        d.reset("quorum-flapping")
        d.reset("quorum-no-transport")


def _both(fn, monkeypatch):
    """``fn(res, journal, snapshot)`` on the JAX package, then on the port,
    each with its clock frozen at ``clock["t"]``; both results."""
    out = []
    for res, j, snap in ((ref_res, ref_journal, ref_process_snapshot), (resilience, journal, process_snapshot)):
        clock = {"t": 1000.0}
        monkeypatch.setattr(res, "_now", lambda c=clock: c["t"])
        out.append(fn(res, j, snap, clock))
    return out


def _delta(after, before):
    return {k: after[k] - before[k] for k in COUNTERS}


# ---------------------------------------------------------------------------
# probation
# ---------------------------------------------------------------------------


def test_probation_lifecycle_readmits_without_manual_reset(monkeypatch):
    def scenario(res, j, snap, clock):
        j.enable()
        res.configure_probation(base_cooldown_s=10.0, backoff=2.0)
        before = snap()
        gates = [res.channel_gate()]
        res.mark_channel_suspect()
        gates += [res.channel_is_suspect(), res.channel_gate()]
        clock["t"] += 10.5  # the cooldown elapsed: one probe admitted
        gates.append(res.channel_gate())
        res.channel_probe_succeeded()
        gates += [res.channel_is_suspect(), res.channel_gate()]
        after = snap()
        episode = after["suspect_episode_s"] - before["suspect_episode_s"]
        return gates, _delta(after, before), episode, [e.kind for e in j.events()]

    ref, got = _both(scenario, monkeypatch)
    assert got == ref
    gates, delta, episode, kinds = got
    assert gates == ["open", True, "refuse", "probe", False, "open"]
    assert delta["channel_readmits"] == 1 and delta["channel_resets"] == 0  # no manual reset
    assert episode >= 10.5
    assert kinds == ["health.channel_suspect", "health.channel_probe", "health.channel_readmit"]


def test_probe_failure_doubles_cooldown_capped(monkeypatch):
    def scenario(res, j, snap, clock):
        res.configure_probation(base_cooldown_s=10.0, max_cooldown_s=15.0, backoff=2.0)
        clock["t"] = 0.0
        res.mark_channel_suspect()
        clock["t"] = 10.5
        gates = [res.channel_gate()]
        res.mark_channel_suspect()  # the probe FAILED: doubled, capped at 15
        gates.append(res.channel_gate())
        clock["t"] = 21.0  # the base elapsed again, the cooldown is 15 now
        gates.append(res.channel_gate())
        clock["t"] = 26.0
        gates.append(res.channel_gate())
        res.channel_probe_succeeded()
        return gates + [res.channel_gate()]

    ref, got = _both(scenario, monkeypatch)
    assert got == ref == ["probe", "refuse", "refuse", "probe", "open"]


def test_mark_suspect_while_suspect_is_idempotent(monkeypatch):
    def scenario(res, j, snap, clock):
        res.configure_probation(base_cooldown_s=10.0)
        clock["t"] = 0.0
        before = snap()["channel_suspect_latched"]
        res.mark_channel_suspect()
        clock["t"] = 5.0
        res.mark_channel_suspect()  # mid-cooldown: no restart
        clock["t"] = 10.5
        return res.channel_gate(), snap()["channel_suspect_latched"] - before

    ref, got = _both(scenario, monkeypatch)
    assert got == ref == ("probe", 1)


# ---------------------------------------------------------------------------
# membership epochs
# ---------------------------------------------------------------------------


def test_advance_membership_is_epoch_guarded(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(resilience, "_full_world", lambda: 4)

    def scenario(res, j, snap, clock):
        m0 = res.current_membership()
        trail = [(m0.epoch, m0.degraded, res.effective_world())]
        m1 = res.advance_membership([0, 1, 2], 1)
        trail.append((m1.epoch, m1.degraded, res.live_ranks(), res.effective_world(), res.live_count()))
        stale = res.advance_membership([0, 1, 2, 3], 1)  # an equal epoch is a no-op
        trail.append((stale.epoch, res.live_ranks()))
        m2 = res.advance_membership([0, 1, 2, 3], 2, reason="readmit")
        trail.append((m2.epoch, m2.degraded, res.effective_world(), res.membership_epoch()))
        return trail

    ref, got = _both(scenario, monkeypatch)
    assert got == ref
    assert got[1] == (1, True, (0, 1, 2), 3, 3) and got[2] == (1, (0, 1, 2)) and got[3] == (2, False, 4, 2)


def test_quorum_flapping_warns_once(monkeypatch):
    def scenario(res, j, snap, clock):
        d = ref_diagnostics if res is ref_res else diagnostics
        d.reset("quorum-flapping")
        res.note_sync_round()
        res._note_shrink(None)  # the first shrink: no warning
        first = d.seen("quorum-flapping")
        res.note_sync_round()
        res._note_shrink(None)  # the second within the window warns
        return first, d.seen("quorum-flapping")

    ref, got = _both(scenario, monkeypatch)
    assert got == ref == (False, True)


# ---------------------------------------------------------------------------
# the adaptive controller and the timeout's precedence
# ---------------------------------------------------------------------------


def test_get_sync_timeout_precedence(monkeypatch):
    trail = []
    for res, timeout in ((ref_res, ref_get_sync_timeout), (resilience, get_sync_timeout)):
        monkeypatch.setenv("METRICS_TPU_SYNC_TIMEOUT_S", "123")
        got = [timeout(7.0), timeout()]  # explicit beats everything, env beats the default
        res._set_adaptive_timeout(42.0)
        got += [timeout(), timeout(7.0)]  # adaptive beats env, explicit still wins
        res._set_adaptive_timeout(None)
        monkeypatch.delenv("METRICS_TPU_SYNC_TIMEOUT_S")
        trail.append(got + [timeout()])
    assert trail[1] == trail[0] == [7.0, 123.0, 42.0, 7.0, DEFAULT_SYNC_TIMEOUT_S]


def _controller_trail(res, j, gathers, watchdog=False, **kw):
    ctrl = res.AdaptiveController(**kw).start()
    try:
        timeouts = []
        for gather_s in gathers:
            j.record("sync.resolve", label="m", gather_s=gather_s)
            timeouts.append(res.adaptive_sync_timeout())
        if watchdog:
            j.record("health.watchdog", label="m", timeout_s=res.adaptive_sync_timeout())
            timeouts.append(res.adaptive_sync_timeout())
        events = [(e.label, e.fields["timeout_s"]) for e in j.events(kinds=["controller.timeout"])]
        return timeouts, events, res.last_schedule_decisions()
    finally:
        ctrl.stop()


def test_controller_commits_ewma_timeout_with_hysteresis(monkeypatch):
    def scenario(res, j, snap, clock):
        j.enable()
        return _controller_trail(res, j, (0.5, 0.5, 4.0), floor_s=1.0, multiplier=4.0, alpha=0.5, hysteresis=0.25)

    ref, got = _both(scenario, monkeypatch)
    assert got == ref
    timeouts, events, _ = got
    assert timeouts == pytest.approx([2.0, 2.0, 9.0])
    assert [label for label, _ in events] == ["ewma", "ewma"]  # the repeat stayed within hysteresis
    assert get_sync_timeout() == pytest.approx(9.0)


def test_controller_backs_off_under_watchdog_pressure(monkeypatch):
    def scenario(res, j, snap, clock):
        j.enable()
        return _controller_trail(res, j, (0.5,), watchdog=True, floor_s=1.0, multiplier=4.0)

    ref, got = _both(scenario, monkeypatch)
    assert got == ref
    assert got[0] == pytest.approx([2.0, 4.0]) and got[1][-1][0] == "watchdog_pressure"


def test_controller_membership_schedule_decisions_and_revert(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(resilience, "_full_world", lambda: 4)

    def scenario(res, j, snap, clock):
        j.enable()
        ctrl = res.AdaptiveController().start()
        try:
            res.advance_membership([0, 1, 2], 1)
            shrunk = res.last_schedule_decisions()
            res.advance_membership([0, 1, 2, 3], 2, reason="readmit")
            restored = res.last_schedule_decisions()
            n_schedule = len(j.events(kinds=["controller.schedule"]))
        finally:
            ctrl.stop()
        ctrl.revert()
        return (shrunk, restored, n_schedule, res.last_schedule_decisions(), res.adaptive_sync_timeout(),
                len(j.events(kinds=["controller.revert"])))

    ref, got = _both(scenario, monkeypatch)
    assert got == ref
    shrunk, restored, n_schedule, after, timeout, reverts = got
    assert shrunk["sync_cadence_multiplier"] == {"value": 2, "epoch": 1, "reason": "degraded membership"}
    assert shrunk["staleness_policy"]["value"] == "snapshot"
    assert restored["sync_cadence_multiplier"]["value"] == 1 and restored["sync_cadence_multiplier"]["epoch"] == 2
    assert (n_schedule, after, timeout, reverts) == (4, {}, None, 1)


# ---------------------------------------------------------------------------
# the fleets: one scenario on both packages' thread worlds
# ---------------------------------------------------------------------------


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _mixed_state(rank, jax_side):
    """Mixed dtypes, reductions, uneven cat rows and a CatBuffer, as the JAX
    suite's, in either package."""
    xp = jnp if jax_side else torch
    f32, i32 = (jnp.float32, jnp.int32) if jax_side else (torch.float32, torch.int32)
    buf = (RefCatBuffer if jax_side else CatBuffer)(8)
    buf.append(xp.arange(2 + rank, dtype=f32) + 10.0 * rank)
    state = {
        "sum_f32": xp.asarray([[1.5, 2.5]]) * (rank + 1) if jax_side else torch.tensor([[1.5, 2.5]]) * (rank + 1),
        "sum_i32": xp.asarray([2, 3], dtype=i32) + rank,
        "mean_f32": xp.asarray([0.25, 0.75]) + rank if jax_side else torch.tensor([0.25, 0.75]) + rank,
        "max_f32": xp.asarray(1.0 + 3 * rank, dtype=f32),
        "cat_f32": xp.arange(3 + rank, dtype=f32) + 10.0 * rank,
        "buf": buf,
    }
    reductions = {"sum_f32": "sum", "sum_i32": "sum", "mean_f32": "mean", "max_f32": "max", "cat_f32": "cat",
                  "buf": "cat"}
    return state, reductions


@pytest.fixture
def fleets(monkeypatch):
    """``make(world, profile_kwargs, jax_side)``: an installed fleet of either
    package (a later one uninstalls the earlier)."""
    holder = {"world": None}

    def make(world=4, jax_side=False, **profile):
        if holder["world"] is not None:
            holder["world"].uninstall()
        clear_sync_plan_cache()
        ref_clear_plans()
        if jax_side:
            w = fake_world.FleetWorld(world, fake_world.FaultProfile(**profile))
        else:
            w = TorchFleetWorld(world, FaultProfile(**profile))
        w.install(monkeypatch)
        holder["world"] = w
        return w

    yield make
    if holder["world"] is not None:
        holder["world"].uninstall()


def _sync_fn(jax_side):
    return ref_host_sync_state if jax_side else host_sync_state


@pytest.mark.parametrize("fused", [True, False])
def test_all_live_quorum_bit_identical_to_full_sync(fleets, fused):
    runs = {}
    for jax_side in (True, False):
        for on_missing in ("quorum", "raise"):
            world = fleets(world=2, jax_side=jax_side)

            def body(rank):
                state, reds = _mixed_state(rank, jax_side)
                return state_bits(_sync_fn(jax_side)(state, reds, update_count=1, timeout=0, fused=fused,
                                                       on_missing=on_missing))

            runs[(jax_side, on_missing)] = world.run(body)
            if on_missing == "quorum":
                assert world.gather_rounds_degraded == 0  # every rank live: no shrink
    port_quorum = runs[(False, "quorum")]
    assert port_quorum[0] == port_quorum[1]
    assert port_quorum == runs[(False, "raise")] == runs[(True, "quorum")] == runs[(True, "raise")]


class _Sum(Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class _RefSum(RefMetric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", jnp.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + jnp.sum(x)

    def compute(self):
        return self.total


def _metric(jax_side, **kw):
    return _RefSum(**kw) if jax_side else _Sum(**kw)


def _feed(jax_side, values):
    return jnp.asarray(values, jnp.float32) if jax_side else torch.tensor(values, dtype=torch.float32)


def test_all_live_quorum_overlapped_bit_identical(fleets):
    out = {}
    for jax_side in (True, False):
        world = fleets(world=2, jax_side=jax_side)

        def body(rank):
            feed = _feed(jax_side, [1.0 + rank, 2.0 * (rank + 1)])
            over = _metric(jax_side, sync_timeout=0, sync_on_missing="quorum")
            block = _metric(jax_side, sync_timeout=0, sync_on_missing="quorum")
            over.update(feed)
            block.update(feed)
            block.sync()
            over.sync(blocking=False)  # a quorum-mode background round
            over.sync()  # resolved
            bits = (_np(over._state["total"]).tobytes(), _np(block._state["total"]).tobytes())
            over.unsync()
            block.unsync()
            return bits

        out[jax_side] = world.run(body)
        assert world.gather_rounds_degraded == 0
    for over_bits, block_bits in out[False]:
        assert over_bits == block_bits
    assert out[False] == out[True]


def test_probe_round_readmits_through_real_sync(fleets):
    """A suspect channel refuses; a cooldown of 0 admits the next sync as the
    probe round, whose success readmits the channel, on both packages."""
    results = {}
    for jax_side in (True, False):
        res = ref_res if jax_side else resilience
        snap = ref_process_snapshot if jax_side else process_snapshot
        xp_state = (lambda r: {"s": jnp.asarray(1.0 + r)}) if jax_side else (lambda r: {"s": torch.tensor(1.0 + r)})
        before = snap()
        world = fleets(world=2, jax_side=jax_side)
        res.configure_probation(base_cooldown_s=3600.0)

        def refused(rank):
            res.mark_channel_suspect()
            with pytest.raises(SyncTimeoutError if not jax_side else Exception, match="refused"):
                _sync_fn(jax_side)(xp_state(rank), {"s": "sum"}, update_count=1, timeout=0, on_missing="quorum")
            return True

        assert world.run(refused) == [True, True]
        world = fleets(world=2, jax_side=jax_side)
        res.configure_probation(base_cooldown_s=0.0)  # probe at once

        def probed(rank):
            res.mark_channel_suspect()
            synced = _sync_fn(jax_side)(xp_state(rank), {"s": "sum"}, update_count=1, timeout=0,
                                        on_missing="quorum")
            return float(_np(synced["s"])), res.channel_is_suspect()

        results[jax_side] = (world.run(probed), _delta(snap(), before))
    assert results[False] == results[True]
    values, delta = results[False]
    assert values == [(3.0, False), (3.0, False)]
    assert delta["channel_readmits"] == 2 and delta["channel_resets"] == 0


def _round_state(rank, step, jax_side):
    if jax_side:
        return {"s": jnp.asarray(float(10 * rank + step)),
                "c": jnp.arange(1 + rank % 2, dtype=jnp.float32) + rank + step}, {"s": "sum", "c": "cat"}
    return {"s": torch.tensor(float(10 * rank + step)),
            "c": torch.arange(1 + rank % 2, dtype=torch.float32) + rank + step}, {"s": "sum", "c": "cat"}


def _drive_quorum(world, steps, jax_side, state_fn=_round_state):
    res = ref_res if jax_side else resilience

    def body(rank):
        outs = []
        for step in range(steps):
            world.begin_round(rank, step)
            state, reds = state_fn(rank, step, jax_side)
            synced = _sync_fn(jax_side)(state, reds, update_count=1, timeout=0, on_missing="quorum",
                                        metric_name="fleet")
            outs.append(state_bits(synced))
        return outs, res.membership_epoch(), res.live_ranks()

    return world.run(body)


def _fleet_both(fleets, steps, world=4, state_fn=_round_state, **profile):
    """One quorum scenario on both fleets: ``{jax_side: (results, world,
    counter delta)}``."""
    out = {}
    for jax_side in (True, False):
        snap = ref_process_snapshot if jax_side else process_snapshot
        before = snap()
        w = fleets(world=world, jax_side=jax_side, **profile)
        results = _drive_quorum(w, steps, jax_side, state_fn)
        out[jax_side] = (results, w, _delta(snap(), before))
    return out


def test_dead_rank_shrinks_within_one_epoch_survivors_bit_equal(fleets):
    out = _fleet_both(fleets, 3, preempt_at={3: 1})
    (ref, ref_world, ref_delta), (got, world, delta) = out[True], out[False]
    assert world.preempted == ref_world.preempted == {3}
    assert got[3] is None
    for rank in (0, 1, 2):
        outs, epoch, live = got[rank]
        assert (epoch, live) == (1, (0, 1, 2))  # one transition, no manual reset
        assert got[rank] == ref[rank]  # values, epoch and live set: the JAX package's
    assert got[0][0] == got[1][0] == got[2][0]
    # the post-death rounds equal a survivors-only fleet's
    survivors = fleets(world=3)
    only = _drive_quorum(survivors, 3, jax_side=False)
    for rank in (0, 1, 2):
        assert got[rank][0][1:] == only[rank][0][1:]
    assert delta == ref_delta and delta["quorum_shrinks"] > 0 and delta["channel_resets"] == 0


def test_transient_drop_degrades_then_readmits(fleets):
    """Rank 2 is partitioned for rounds 1-2: the survivors shrink, rank 2
    serves a quorum of one, and every rank readmits within one round."""
    def state_fn(rank, step, jax_side):
        value = float(10 * rank + step)
        return ({"s": jnp.asarray(value)} if jax_side else {"s": torch.tensor(value)}), {"s": "sum"}

    out = _fleet_both(fleets, 5, state_fn=state_fn, drop_rounds={2: (1, 2)})
    (ref, _, ref_delta), (got, world, delta) = out[True], out[False]
    assert got == ref
    full, survivors = (0, 1, 2, 3), (0, 1, 3)

    def value(outs, step):
        dtype, shape, raw = outs[step]["s"]
        return float(np.frombuffer(raw, dtype=dtype)[0])

    for rank in range(4):
        outs, epoch, live = got[rank]
        assert (value(outs, 0), value(outs, 3), value(outs, 4)) == (60.0, 72.0, 76.0)
        assert (epoch, live) == (2, full)
    for rank in survivors:
        assert (value(got[rank][0], 1), value(got[rank][0], 2)) == (43.0, 46.0)
    assert (value(got[2][0], 1), value(got[2][0], 2)) == (21.0, 22.0)  # a quorum of one
    assert world.gather_rounds_degraded > 0
    assert delta == ref_delta and delta["quorum_shrinks"] > 0 and delta["quorum_readmits"] > 0
    assert delta["channel_resets"] == 0


def test_hazard_preemption_is_deterministic():
    sets = []
    for cls, profile in ((fake_world.FleetWorld, fake_world.FaultProfile), (TorchFleetWorld, FaultProfile)):
        world = cls(8, profile(preempt_hazard=0.5, seed=7))

        def body(rank, world=world):
            world.begin_round(rank, 0)
            return True

        world.run(body)
        sets.append(world.preempted)
    import zlib

    expected = {r for r in range(8) if zlib.crc32(f"7:{r}:0".encode()) / 2**32 < 0.5}
    assert sets[1] == sets[0] == expected


def test_fleet_w64_smoke(fleets):
    W, dead, steps = 64, {5: 2, 17: 2}, 4

    def state_fn(rank, step, jax_side):
        value = float(rank + step)
        return ({"s": jnp.asarray(value)} if jax_side else {"s": torch.tensor(value)}), {"s": "sum"}

    world = fleets(world=W, preempt_at=dead, jitter_s=0.0005)
    got = _drive_quorum(world, steps, False, state_fn)
    assert world.preempted == set(dead)
    survivors = [r for r in range(W) if r not in dead]
    expected_final = float(sum(r + (steps - 1) for r in survivors))
    for rank in survivors:
        outs, epoch, live = got[rank]
        assert (epoch, live) == (1, tuple(survivors))
        assert outs[-1] == got[survivors[0]][0][-1]
        dtype, shape, raw = outs[-1]["s"]
        assert float(np.frombuffer(raw, dtype=dtype)[0]) == expected_final
    assert world.gather_rounds_degraded > 0
    # the JAX package's fleet serves the same final round
    ref_world = fleets(world=W, jax_side=True, preempt_at=dead, jitter_s=0.0005)
    ref = _drive_quorum(ref_world, steps, True, state_fn)
    assert [ref[r][0][-1] for r in survivors] == [got[r][0][-1] for r in survivors]


def test_async_quorum_shrinks_partitioned_rank_at_resolve(fleets):
    """Rank 2 is partitioned while quorum-mode overlapped rounds run: the
    round's gather fails on its lane, the retry there negotiates the
    survivors, the resolve serves the survivors' values, on both packages."""
    out = {}
    for jax_side in (True, False):
        res = ref_res if jax_side else resilience
        snap = ref_process_snapshot if jax_side else process_snapshot
        before = snap()
        world = fleets(world=3, jax_side=jax_side, drop_rounds={2: (1, 10)})

        def body(rank):
            m = _metric(jax_side, sync_timeout=0, sync_on_missing="quorum")
            if jax_side:
                m.distributed_available_fn = lambda: True
            values = []
            for step, base in ((0, 1.0), (1, 10.0)):
                world.begin_round(rank, step)
                m.update(_feed(jax_side, [base + rank]))
                m.sync(blocking=False)
                m.sync()  # resolve
                values.append(float(_np(m._state["total"])))
                if step == 0:
                    m.unsync()
            return values, res.membership_epoch(), res.live_ranks(), res.channel_is_suspect()

        out[jax_side] = (world.run(body), world.gather_rounds_degraded > 0, _delta(snap(), before))
    assert out[False] == out[True]
    results, degraded, delta = out[False]
    assert results[0] == results[1] == ([6.0, 24.0], 1, (0, 1), False)
    assert results[2] == ([6.0, 15.0], 1, (2,), False)  # a quorum of one on its own lane
    assert degraded and delta["quorum_shrinks"] > 0 and delta["channel_resets"] == 0


def test_controller_decisions_symmetric_across_event_streams(monkeypatch):
    """Per-rank controllers fed the same events commit the same journaled
    decisions, on both packages."""
    def drive(res, j, snap, clock):
        j.enable()
        try:
            timeouts, events, decisions = _controller_trail(
                res, j, (0.5, 0.5, 4.0), watchdog=True, floor_s=1.0, multiplier=4.0, alpha=0.5, hysteresis=0.25)
            return res.adaptive_sync_timeout(), decisions, events
        finally:
            res.AdaptiveController().revert()
            j.clear()

    ranks = _both(drive, monkeypatch) + _both(drive, monkeypatch)
    assert ranks[0] == ranks[1] == ranks[2] == ranks[3]
    assert ranks[1][0] == pytest.approx(18.0)
    assert [label for label, _ in ranks[1][2]] == ["ewma", "ewma", "watchdog_pressure"]


# ---------------------------------------------------------------------------
# the port's own: another process group, the in-program sync, membership skew
# ---------------------------------------------------------------------------


def test_quorum_with_another_process_group_raises():
    """Quorum negotiates the default world; the port's process_group is a
    real group (the JAX package's host sync takes none), so the pair
    raises at construction, at sync() and in host_sync_state."""
    group = [0, 1]
    with pytest.raises(MetricsTPUUserError, match="default torch.distributed world"):
        _Sum(sync_on_missing="quorum", process_group=group)
    m = _Sum(process_group=group)
    with pytest.raises(MetricsTPUUserError, match="default torch.distributed world"):
        m.sync(on_missing="quorum", distributed_available=lambda: True)
    with pytest.raises(MetricsTPUUserError, match="default torch.distributed world"):
        host_sync_state({"s": torch.ones(())}, {"s": "sum"}, group, on_missing="quorum")
    assert _Sum(sync_on_missing="quorum").sync_on_missing == "quorum"


def test_in_program_sync_takes_no_part_in_quorum(monkeypatch):
    """Under a degraded membership the in-program sync runs over its axis as
    given, as the JAX package's ``psum`` over a mesh axis does: here over all
    four thread ranks, while the host sync gathers over the survivors."""
    from jax.sharding import Mesh, PartitionSpec as P

    from metrics_tpu.parallel.sync import sync_in_jit as ref_sync_in_jit
    from metrics_tpu_torch.parallel.sync import sync_in_jit

    world = TorchLockstepWorld(4).install(monkeypatch)

    def body(rank):
        resilience.advance_membership([0, 1, 2], 1)
        out = sync_in_jit({"s": torch.tensor(float(rank + 1))}, {"s": "sum"}, axis_name=world.axis("world"))
        return float(out["s"]), resilience.effective_world()

    assert world.run(body) == [(10.0, 3)] * 4
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    ref_res.advance_membership([0, 1, 2], 1)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("world",))
    fn = jax.shard_map(lambda x: ref_sync_in_jit({"s": x}, {"s": "sum"}, "world")["s"], mesh=mesh,
                       in_specs=P("world"), out_specs=P())
    assert float(fn(jnp.arange(1.0, 5.0))[0]) == 10.0
    assert ref_res.effective_world() == 3


def test_membership_skew_raises_on_every_rank(monkeypatch):
    """A rank that missed a transition reports another membership epoch in
    its health word: every rank raises StateDivergenceError before any
    payload moves, as in the JAX package."""
    world = TorchLockstepWorld(4).install(monkeypatch)

    def body(rank):
        if rank == 3:
            resilience.advance_membership([0, 1, 2, 3], 1, reason="readmit")
        return host_sync_state({"s": torch.tensor(1.0)}, {"s": "sum"}, update_count=1)

    assert world.run_catching(body) == [StateDivergenceError] * 4
    assert world.calls == 1  # the header only


def test_a_lost_peer_is_the_missing_rank_class(monkeypatch):
    """gloo reports a gone peer's closed connection at once, where the JAX
    package's collective waits on it until the watchdog fires: the port
    raises SyncTimeoutError (the class quorum acts on) and puts the channel
    in probation, as a fired watchdog does. Other backend errors pass."""
    monkeypatch.setattr(sync_mod, "_collective_device", lambda group=None: torch.device("cpu"))

    def closed(x, group):
        raise RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection closed by peer [127.0.0.1]:20675. "
                           "This is typically caused by a remote worker crashing.")

    monkeypatch.setattr(sync_mod, "_all_gather", closed)
    for timeout in (0, 30):  # inline, and on the watchdog's worker
        with pytest.raises(SyncTimeoutError, match="a peer process is gone"):
            sync_mod._gather(torch.ones(2), None, timeout=timeout)
        assert resilience.channel_is_suspect() and resilience.channel_gate() == "refuse"
        resilience.reset_channel_health()

    def bad(x, group):
        raise RuntimeError("Tensors must be contiguous")

    monkeypatch.setattr(sync_mod, "_all_gather", bad)
    with pytest.raises(RuntimeError, match="contiguous") as info:
        sync_mod._gather(torch.ones(2), None, timeout=0)
    assert not isinstance(info.value, SyncTimeoutError) and not resilience.channel_is_suspect()


@pytest.mark.parametrize("modes", [("quorum", "quorum"), ("quorum", "raise"), ("local", "raise"), ("local", "local")])
def test_collection_goes_to_quorum_only_when_every_member_asks(fleets, modes):
    """A collection's combined sync runs under quorum only when every member
    asks for it, and degrades a missing-rank failure when some member asks
    for ``"local"``: rank 2 dies at step 1, and each survivor's outcome (the
    synced values, or the error it raised) is the JAX package's."""
    import warnings

    from metrics_tpu.core.collections import MetricCollection as RefMetricCollection
    from metrics_tpu_torch.core.collections import MetricCollection

    out = {}
    for jax_side in (True, False):
        res = ref_res if jax_side else resilience
        world = fleets(world=3, jax_side=jax_side, preempt_at={2: 1})

        def body(rank):
            coll = RefMetricCollection if jax_side else MetricCollection
            mc = coll({k: _metric(jax_side, sync_timeout=0, sync_on_missing=mode) for k, mode in zip("ab", modes)})
            trail = []
            for step in range(2):
                world.begin_round(rank, step)
                mc.update(_feed(jax_side, [1.0 + rank + 10 * step]))
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        mc.sync()
                except Exception as err:  # noqa: BLE001 - the class is the outcome
                    trail.append(type(err).__name__)
                    continue
                trail.append(tuple(float(_np(m._state["total"])) for m in mc.values()))
                mc.unsync()
            return trail, res.membership_epoch()

        out[jax_side] = world.run(body)
    assert out[False] == out[True]
    assert out[False][0][0][0] == (6.0, 6.0)  # step 0, every rank live: 1 + 2 + 3
    if modes == ("quorum", "quorum"):
        assert out[False][0] == ([(6.0, 6.0), (26.0, 26.0)], 1)  # the survivors: 1 + 11 + 2 + 12, epoch 1
    if modes == ("local", "local"):
        assert out[False][1] == ([(6.0, 6.0), (14.0, 14.0)], 0)  # rank 1's own 2 + 12, no shrink
