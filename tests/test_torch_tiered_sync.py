"""The tiered schedule and the quantized slow hop, against the JAX package.

Port twin of ``tests/parallel/test_tiered_sync.py``, case for case: with a
tier map (``tiering.set_tier_map`` / ``METRICS_TPU_TIER_SIZE``) and a subset
transport, a bucketed sync runs a gather within the tier, one exchange
between the tier leaders and a gather within the tier again; at full
precision it is the flat gather, bit for bit. ``sync_precision`` encodes the
slow hop alone, only when asked, bit-stable from run to run. Asymmetric
maps and mixed precisions raise on every rank through the health word's v5
columns. Each case runs the port's thread world
(``tests/helpers/torch_world.py``) and holds it to the JAX suite's own
``LockstepWorld`` run of the same inputs (``_jax_sync`` and friends, built
once per module): synced bits, byte counters and collective counts. Then
the codec itself (``parallel/quantize.py``): the wire equal to the JAX
package's, byte for byte and length, for float32, float16, bfloat16 and
float64 payloads of 1 to 70,000 elements, ties, NaN and Inf, integers
passing through, ``kahan_sum``, and the codes of a tier of more than two
ranks.
"""
import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.parallel.quantize as ref_quantize
import metrics_tpu.parallel.resilience as ref_res
import metrics_tpu_torch.parallel.resilience as resilience
from metrics_tpu.core.collections import MetricCollection as RefMetricCollection
from metrics_tpu.core.plan import clear_plans as ref_clear_plans
from metrics_tpu.parallel import tiering as ref_tiering
from metrics_tpu.parallel.health import build_health_word as ref_build_health_word
from metrics_tpu.parallel.sync import host_sync_state as ref_host_sync_state
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.plan import clear_plans, tier_schedule_for
from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.observability.trace_export import chrome_trace
from metrics_tpu_torch.parallel import quantize, tiering
from metrics_tpu_torch.parallel.health import build_health_word, reset_channel_health
from metrics_tpu_torch.parallel.quantize import validate_sync_precision
from metrics_tpu_torch.parallel.sync import host_sync_state
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, StateDivergenceError
from tests.helpers import fake_world
from tests.helpers.torch_world import FaultProfile, TorchFleetWorld, TorchLockstepWorld, state_bits
from tests.parallel import test_tiered_sync as ref_suite

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

WORLD = 8


@pytest.fixture(autouse=True)
def _fresh_tiering():
    for reset in (clear_plans, ref_clear_plans, tiering.reset_tiering, ref_tiering.reset_tiering,
                  reset_channel_health, journal.clear):
        reset()
    yield
    for reset in (clear_plans, ref_clear_plans, tiering.reset_tiering, ref_tiering.reset_tiering,
                  reset_channel_health, journal.disable, journal.clear):
        reset()


@contextlib.contextmanager
def _lockstep(world=WORLD, tier_size=None):
    """The port's thread world over every seam the tiered stack reaches
    through and, given ``tier_size``, the tier map and the world as the tier
    transport."""
    with pytest.MonkeyPatch.context() as mp:
        w = TorchLockstepWorld(world).install(mp)
        if tier_size is not None:
            tiering.set_tier_map(tier_size)
            tiering.set_tier_transport(w)
        try:
            yield w
        finally:
            tiering.reset_tiering()
            clear_plans()
            w.shutdown_executors()


def _mixed_state(rank):
    """The JAX suite's ``_mixed_state`` in torch: every payload class."""
    buf = CatBuffer(16)
    buf.append(torch.arange(2 + rank, dtype=torch.float32) + 10.0 * rank)
    state = {
        "sum_f32": torch.tensor([[1.5, 2.5]]) * (rank + 1),
        "sum_i32": torch.tensor([2, 3], dtype=torch.int32) + rank,
        "mean_f32": torch.tensor([0.25, 0.75]) + rank,
        "max_f32": torch.tensor(1.0 + 3 * rank),
        "cat_f32": torch.arange(3 + rank, dtype=torch.float32) + 10.0 * rank,
        "buf": buf,
    }
    return state, {"sum_f32": "sum", "sum_i32": "sum", "mean_f32": "mean", "max_f32": "max", "cat_f32": "cat",
                   "buf": "cat"}


def _run_sync(tier_size=None, sync_precision=None, world=WORLD):
    """One host_sync_state round on every port rank: (state bits, stats,
    collective rounds) per rank."""
    with _lockstep(world, tier_size) as w:

        def body(rank):
            state, reds = _mixed_state(rank)
            stats = {}
            synced = host_sync_state(state, reds, update_count=1, timeout=0, metric_name="tiered",
                                     sync_precision=sync_precision, stats=stats)
            return state_bits(synced), stats, w.calls

        return w.run(body)


@functools.lru_cache(maxsize=None)
def _jax_sync(tier_size=None, sync_precision=None, world=WORLD):
    """The JAX suite's round on its own LockstepWorld, the same inputs."""
    with ref_suite._lockstep(world, tier_size) as w:

        def body(rank):
            state, reds = ref_suite._mixed_state(rank)
            stats = {}
            synced = ref_host_sync_state(state, reds, update_count=1, timeout=0, metric_name="tiered",
                                         sync_precision=sync_precision, stats=stats)
            return state_bits(synced), stats, w.calls

        return w.run(body)


# ---------------------------------------------------------------------------
# full precision: tiered is the flat gather, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier_size", [2, 4])
def test_tiered_full_precision_bit_identical_to_flat(tier_size):
    flat = _run_sync()
    tiered = _run_sync(tier_size=tier_size)
    ref = _jax_sync(tier_size=tier_size)
    for rank in range(WORLD):
        assert tiered[rank][0] == flat[rank][0] == ref[rank][0], rank
        assert tiered[rank][1] == ref[rank][1], rank  # the byte counters: the JAX package's
    assert all(tiered[r][0] == tiered[0][0] for r in range(WORLD))
    assert tiered[0][1]["intra_tier_bytes"] > 0 and tiered[0][1]["inter_tier_bytes"] > 0


def test_tiered_mean_matches_flat_bitwise():
    flat, tiered = _run_sync(), _run_sync(tier_size=2)
    ref = _jax_sync(tier_size=2)
    for rank in range(WORLD):
        assert tiered[rank][0]["mean_f32"] == flat[rank][0]["mean_f32"] == ref[rank][0]["mean_f32"]


def test_flat_world_pays_zero_extra_collectives():
    """No map, one tier or one rank a tier: the flat path, with the flat
    collective count, which is the JAX package's."""
    flat = _run_sync()
    single_tier = _run_sync(tier_size=WORLD)
    per_rank = _run_sync(tier_size=1)
    for rank in range(WORLD):
        assert single_tier[rank][0] == per_rank[rank][0] == flat[rank][0]
    assert single_tier[0][2] == per_rank[0][2] == flat[0][2] == _jax_sync()[0][2]
    assert "inter_tier_bytes" not in single_tier[0][1]


# ---------------------------------------------------------------------------
# the overlapped round and the grouped collection run the same schedule
# ---------------------------------------------------------------------------


class _Sum(Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + torch.sum(x)
        self.count = self.count + torch.tensor(x.numel(), dtype=torch.int32)

    def compute(self):
        return self.total / self.count


def _metric_bits(m):
    return tuple(state_bits({n: m._state[n]})[n][2] for n in sorted(m._defaults))


def _run_overlapped(tier_size, jax_side=False):
    lockstep, cls = (ref_suite._lockstep, ref_suite._Sum) if jax_side else (_lockstep, _Sum)
    with lockstep(WORLD, tier_size) as w:

        def body(rank):
            values = [1.0 + rank, 2.0 * (rank + 1)]
            feed = jnp.asarray(values) if jax_side else torch.tensor(values)
            over, block = cls(sync_timeout=0), cls(sync_timeout=0)
            over.update(feed)
            block.update(feed)
            block.sync()
            over.sync(blocking=False)  # the overlapped launch rides the same schedule
            over.sync()
            bits = (_metric_bits(over), _metric_bits(block))
            over.unsync()
            block.unsync()
            return bits

        return w.run(body)


@pytest.mark.parametrize("tier_size", [2, 4])
def test_overlapped_round_bit_identical_tiered_vs_blocking(tier_size):
    flat, tiered = _run_overlapped(None), _run_overlapped(tier_size)
    ref = _run_overlapped(tier_size, jax_side=True)
    for rank in range(WORLD):
        over_bits, block_bits = tiered[rank]
        assert over_bits == block_bits == flat[rank][0] == ref[rank][0]


def _run_grouped(tier_size, jax_side=False):
    lockstep, cls, coll = ((ref_suite._lockstep, ref_suite._Sum, RefMetricCollection) if jax_side
                           else (_lockstep, _Sum, MetricCollection))
    with lockstep(WORLD, tier_size) as w:

        def body(rank):
            mc = coll({"a": cls(sync_timeout=0), "b": cls(sync_timeout=0)})
            values = [1.0 + rank, 0.5 * rank]
            mc.update(jnp.asarray(values) if jax_side else torch.tensor(values))
            mc.sync()  # one fused round for the whole collection
            bits = tuple(_metric_bits(m) for m in mc.values())
            mc.unsync()
            return bits

        return w.run(body)


@pytest.mark.parametrize("tier_size", [2, 4])
def test_grouped_fused_collection_bit_identical_tiered_vs_flat(tier_size):
    flat, tiered = _run_grouped(None), _run_grouped(tier_size)
    ref = _run_grouped(tier_size, jax_side=True)
    for rank in range(WORLD):
        assert tiered[rank] == flat[rank] == ref[rank]


# ---------------------------------------------------------------------------
# the quantized slow hop: opt-in, the JAX package's bits, bit-stable
# ---------------------------------------------------------------------------

_FLOAT_KEYS = ("sum_f32", "mean_f32", "max_f32", "cat_f32", "buf")


def _floats(bits):
    return {k: np.frombuffer(bits[k][-1], np.float32) for k in _FLOAT_KEYS}


def _check_quantized(precision, rtol, atol):
    """Bit-stable, within the JAX suite's tolerances of the flat sync, and
    the JAX package's values and byte counters bit for bit (these payloads'
    in-tier sums are exact)."""
    flat = _run_sync()
    q1 = _run_sync(tier_size=4, sync_precision=precision)
    q2 = _run_sync(tier_size=4, sync_precision=precision)
    ref = _jax_sync(tier_size=4, sync_precision=precision)
    for rank in range(WORLD):
        assert q1[rank][0] == q2[rank][0] == ref[rank][0], rank
        assert q1[rank][1] == ref[rank][1], rank
        got, want = _floats(q1[rank][0]), _floats(flat[rank][0])
        for name in _FLOAT_KEYS:
            np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)
        assert q1[rank][0]["sum_i32"] == flat[rank][0]["sum_i32"]  # integers pass raw
    assert all(q1[r][0] == q1[0][0] for r in range(WORLD))
    return q1


def test_bf16_slow_hop_within_tolerance_and_bit_stable():
    _check_quantized("bf16", 2e-2, 1e-6)  # the bf16 mantissa


def test_int8_slow_hop_within_tolerance_and_bit_stable():
    _check_quantized("int8", 0.05, 0.1)  # 1/127 of a block's maxabs


def test_quantization_needs_explicit_opt_in():
    with pytest.raises(MetricsTPUUserError, match="sync_precision"):
        validate_sync_precision("fp4")
    with pytest.raises(MetricsTPUUserError, match="sync_precision"):
        _Sum(sync_precision="fp4")
    with pytest.raises(MetricsTPUUserError, match="sync_precision"):
        MetricCollection({"a": _Sum()}, sync_precision="int4")
    assert _Sum(sync_precision="full").sync_precision is None
    assert MetricCollection({"a": _Sum()}, sync_precision="bf16").sync_precision == "bf16"


def test_precision_without_tier_map_stays_flat_and_exact():
    flat, q = _run_sync(), _run_sync(sync_precision="int8")
    for rank in range(WORLD):
        assert q[rank][0] == flat[rank][0]


# ---------------------------------------------------------------------------
# negotiation: asymmetric maps and mixed precisions raise on every rank
# ---------------------------------------------------------------------------


def test_mixed_precision_ranks_raise_on_every_rank():
    with _lockstep(4, tier_size=2) as w:

        def body(rank):
            return host_sync_state({"s": torch.tensor(1.0 + rank)}, {"s": "sum"}, update_count=1, timeout=0,
                                   sync_precision="bf16" if rank % 2 == 0 else None)

        assert w.run_catching(body) == [StateDivergenceError] * 4
        assert w.calls == 1  # the header only


def test_asymmetric_tier_map_raises_on_every_rank():
    with _lockstep(WORLD) as w:
        # ranks < 4 believe a tier size of 2, the others 4
        tiering.set_tier_map(lambda r: r // (2 if w._rank.value < 4 else 4))
        tiering.set_tier_transport(w)

        def body(rank):
            return host_sync_state({"s": torch.tensor(1.0 + rank)}, {"s": "sum"}, update_count=1, timeout=0)

        assert w.run_catching(body) == [StateDivergenceError] * WORLD
        assert w.calls == 1


def test_unconfigured_peer_raises_on_every_rank():
    with _lockstep(4) as w:
        tiering.set_tier_map(lambda r: -1 if w._rank.value == 3 else r // 2)
        tiering.set_tier_transport(w)

        def body(rank):
            return host_sync_state({"s": torch.tensor(1.0)}, {"s": "sum"}, update_count=1, timeout=0)

        assert w.run_catching(body) == [StateDivergenceError] * 4


def test_header_v5_columns_match_the_reference(monkeypatch):
    """member_epoch, live_count, tier and precision of every rank of a fleet
    whose membership shrank to (0, 1, 2) at epoch 1, tier size 2, int8: the
    JAX package's words, column for column."""
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(resilience, "_full_world", lambda: 4)
    for tier in (tiering, ref_tiering):
        tier.set_tier_map(2)
    for res in (resilience, ref_res):
        res.advance_membership([0, 1, 2], 1)
    columns = slice(7, 11)
    try:
        for rank in range(3):
            monkeypatch.setattr(tiering, "_current_rank", lambda r=rank: r)
            monkeypatch.setattr(ref_tiering, "_current_rank", lambda r=rank: r)
            got = build_health_word({"s": torch.ones(())}, {"s": "sum"}, 1, sync_precision="int8")
            want = np.asarray(ref_build_health_word({"s": jnp.ones(())}, {"s": "sum"}, 1, sync_precision="int8"))
            np.testing.assert_array_equal(got[columns], want[columns])
            assert got[columns].tolist() == [1, 3, rank // 2, 2]
    finally:
        for res in (resilience, ref_res):
            res.reset_resilience()


# ---------------------------------------------------------------------------
# the plan layer: one cached schedule per (schema, topology)
# ---------------------------------------------------------------------------


def test_tier_schedule_cached_per_schema_and_topology(monkeypatch):
    monkeypatch.setattr(resilience, "_full_world", lambda: 4)
    monkeypatch.setattr(tiering, "_current_rank", lambda: 0)
    tiering.set_tier_map(2)
    tiering.set_tier_transport(types.SimpleNamespace(subset_allgather=lambda x, ranks: x))
    plan = types.SimpleNamespace(schema_key="k1")
    sched = tier_schedule_for(plan)
    assert (sched.inter_participants, sched.flat_participants, sched.hops_per_bucket) == (2, 4, 3)
    assert tier_schedule_for(plan) is sched
    assert tier_schedule_for(types.SimpleNamespace(schema_key="k2")) is not sched
    clear_plans()
    assert tier_schedule_for(plan) is not sched  # invalidated with the plans
    assert tier_schedule_for(None) is None
    tiering.set_tier_map(None)
    assert tier_schedule_for(plan) is None  # the flat world


# ---------------------------------------------------------------------------
# telemetry: the byte counters, the hop events, the trace's categories
# ---------------------------------------------------------------------------


def test_telemetry_counters_and_hop_events():
    journal.enable()
    tiered = _run_sync(tier_size=4)
    ref = _jax_sync(tier_size=4)
    for key in ("inter_tier_bytes_saved", "inter_tier_bytes", "intra_tier_bytes"):
        total = sum(t[1].get(key, 0) for t in tiered)
        assert total > 0 and total == sum(t[1].get(key, 0) for t in ref), key
    hops = journal.events(kinds=["sync.hop"])
    assert {e.label for e in hops} == {"intra", "inter"}
    assert all(e.fields["tier"] >= 0 and e.fields["participants"] >= 1 for e in hops)
    plans = journal.events(kinds=["plan.tier"])
    assert plans and plans[0].fields["inter_participants"] == 2 and plans[0].fields["flat_participants"] == WORLD
    cats = {ev.get("cat") for ev in chrome_trace()["traceEvents"]}
    assert "sync-intra-tier" in cats and "sync-inter-tier" in cats


def test_metric_surfaces_tier_counters_via_telemetry():
    with _lockstep(4, tier_size=2) as w:

        def body(rank):
            m = _Sum(sync_timeout=0)
            m.update(torch.tensor([1.0 + rank]))
            m.sync()
            stats = m.sync_stats()
            m.unsync()
            return stats

        stats = w.run(body)
    for key in ("inter_tier_bytes", "intra_tier_bytes", "inter_tier_bytes_saved"):
        assert sum(s[key] for s in stats) > 0, key


# ---------------------------------------------------------------------------
# the fleets: a dead rank inside a tier, a dead tier
# ---------------------------------------------------------------------------


@pytest.fixture
def fleets(monkeypatch):
    holder = {"world": None}

    def make(world=4, tier_size=None, jax_side=False, **profile):
        if holder["world"] is not None:
            holder["world"].uninstall()
        clear_plans()
        ref_clear_plans()
        if jax_side:
            w = fake_world.FleetWorld(world, fake_world.FaultProfile(**profile))
        else:
            w = TorchFleetWorld(world, FaultProfile(**profile))
        w.install(monkeypatch)
        if tier_size is not None:
            (ref_tiering if jax_side else tiering).set_tier_map(tier_size)  # the quorum transport carries it
        holder["world"] = w
        return w

    yield make
    if holder["world"] is not None:
        holder["world"].uninstall()


def _drive_fleet(world, steps, jax_side=False):
    res, tier, sync = (ref_res, ref_tiering, ref_host_sync_state) if jax_side else (resilience, tiering,
                                                                                    host_sync_state)
    xp = jnp if jax_side else torch

    def body(rank):
        outs = []
        for step in range(steps):
            world.begin_round(rank, step)
            state = {"s": xp.asarray(float(10 * rank + step)) if jax_side else torch.tensor(float(10 * rank + step)),
                     "c": xp.arange(1 + rank % 2, dtype=xp.float32) + rank + step}
            synced = sync(state, {"s": "sum", "c": "cat"}, update_count=1, timeout=0, on_missing="quorum",
                          metric_name="fleet")
            outs.append(state_bits(synced))
        topo = tier.active_topology()
        layout = None if topo is None else (topo.n_tiers, topo.leaders, topo.live)
        return outs, res.membership_epoch(), res.live_ranks(), layout

    return world.run(body)


def _fleet_both(fleets, steps, world=4, tier_size=None, **profile):
    ref = _drive_fleet(fleets(world, tier_size, jax_side=True, **profile), steps, jax_side=True)
    w = fleets(world, tier_size, **profile)
    return _drive_fleet(w, steps), w, ref


def test_fleet_dead_rank_inside_tier_renegotiates_same_epoch(fleets):
    """Rank 3 (tier 1) dies: one transition to (0, 1, 2), the tiers derived
    again in that epoch (tier 1 is rank 2 alone, which leads it), the values
    a survivors-only fleet's and the JAX package's."""
    got, world, ref = _fleet_both(fleets, 3, tier_size=2, preempt_at={3: 1})
    assert world.preempted == {3} and got[3] is None
    for rank in (0, 1, 2):
        outs, epoch, live, layout = got[rank]
        assert (epoch, live, layout) == (1, (0, 1, 2), (2, (0, 2), (0, 1, 2)))
        assert got[rank] == ref[rank]
    only = _drive_fleet(fleets(3, tier_size=2), 3)
    for rank in (0, 1, 2):
        assert got[rank][0][1:] == only[rank][0][1:]
    assert got[0][0] == got[1][0] == got[2][0]


def test_fleet_dead_tier_collapses_to_degenerate_schedule(fleets):
    got, world, ref = _fleet_both(fleets, 3, tier_size=2, preempt_at={2: 1, 3: 1})
    assert world.preempted == {2, 3}
    only = _drive_fleet(fleets(2, tier_size=2), 3)
    for rank in (0, 1):
        outs, epoch, live, layout = got[rank]
        assert (live, layout) == ((0, 1), None)  # one tier left: the flat path
        assert got[rank] == ref[rank]
        assert outs[1:] == only[rank][0][1:]


def test_fleet_all_live_tiered_bit_identical_to_flat_quorum(fleets):
    tiered = _drive_fleet(fleets(4, tier_size=2), 2)
    flat = _drive_fleet(fleets(4), 2)
    ref = _drive_fleet(fleets(4, tier_size=2, jax_side=True), 2, jax_side=True)
    for rank in range(4):
        assert tiered[rank][0] == flat[rank][0] == ref[rank][0]
        assert tiered[rank][3] == (2, (0, 2), (0, 1, 2, 3))


# ---------------------------------------------------------------------------
# the codec: the JAX package's wire, byte for byte
# ---------------------------------------------------------------------------

LENGTHS = (1, 255, 256, 257, 70_000)
DTYPES = {"float32": (np.float32, torch.float32), "float16": (np.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16), "float64": (np.float64, torch.float64)}


def _payload(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal(n) * np.exp(rng.uniform(-3, 3, n))).astype(np.float32)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wire_equals_the_reference(dtype, precision):
    """Every length's wire equal to the JAX package's (bytes and length),
    and its decode. A float64 payload is float32 on the JAX side, which
    runs without x64, and rounds through float32 on the port's too."""
    np_dtype, torch_dtype = DTYPES[dtype]
    for n in LENGTHS:
        x = _payload(n, n)
        ref_in = jnp.asarray(x).astype(np_dtype)
        port_in = torch.from_numpy(x).to(torch_dtype)
        ref_wire = np.asarray(ref_quantize.encode(ref_in, precision))
        wire = quantize.encode(port_in, precision)
        assert wire.numel() == ref_wire.size == quantize.encoded_size(n, torch_dtype, precision) == \
            ref_quantize.encoded_size(n, ref_in.dtype, precision), (dtype, n)
        got = wire.view(torch.int16).numpy() if wire.dtype == torch.bfloat16 else wire.numpy()
        want = ref_wire.view(np.int16) if precision == "bf16" else ref_wire
        np.testing.assert_array_equal(got, want, err_msg=f"{dtype} n={n}")
        back = quantize.decode(wire, n, torch_dtype, precision).to(torch.float32).numpy()
        ref_back = np.asarray(ref_quantize.decode(jnp.asarray(ref_wire), n, ref_in.dtype, precision)).astype(np.float32)
        np.testing.assert_array_equal(back, ref_back, err_msg=f"{dtype} n={n}")


def test_ties_nan_and_inf_follow_the_reference():
    """Half to even at scale 1.0; a NaN block's scale is 1.0 and its NaN
    encodes as 0; an Inf block's scale is inf and it decodes as NaN."""
    ties = np.zeros(256, np.float32)
    ties[:5] = [0.5, 1.5, -0.5, 2.5, 127.0]  # maxabs 127: the scale is 1.0
    nan_block = np.full(256, 2.0, np.float32)
    nan_block[3] = np.nan
    inf_block = np.full(256, 2.0, np.float32)
    inf_block[7] = np.inf
    x = np.concatenate([ties, nan_block, inf_block, np.arange(10, dtype=np.float32)])
    wire = quantize.encode(torch.from_numpy(x), "int8")
    ref_wire = np.asarray(ref_quantize.encode(jnp.asarray(x), "int8"))
    np.testing.assert_array_equal(wire.numpy(), ref_wire)
    codes, scales = wire[: 4 * 256].numpy(), wire[4 * 256:].numpy().reshape(4, 4)
    assert codes[:5].tolist() == [0, 2, 0, 2, 127]
    assert codes[256 + 3] == 0 and scales[1].tolist() == [0, 0, -128, 63]  # float32 1.0, little-endian
    assert scales[2].tolist() == [0, 0, -128, 127] and not codes[512:768].any()  # float32 inf
    back = quantize.decode(wire, x.size, torch.float32, "int8").numpy()
    ref_back = np.asarray(ref_quantize.decode(jnp.asarray(ref_wire), x.size, jnp.float32, "int8"))
    np.testing.assert_array_equal(back, ref_back)
    assert np.isnan(back[512:768]).all() and back[256 + 3] == 0.0


def test_integers_pass_through():
    for torch_dtype, np_dtype in ((torch.int32, np.int32), (torch.int64, np.int32), (torch.bool, np.bool_)):
        x = torch.arange(300).to(torch_dtype)
        for precision in ("bf16", "int8"):
            assert quantize.encode(x, precision) is x
            assert quantize.decode(x, 300, torch_dtype, precision) is x
            assert quantize.encoded_size(300, torch_dtype, precision) == 300 == \
                ref_quantize.encoded_size(300, np_dtype, precision)


def test_kahan_sum_equals_the_reference():
    rng = np.random.RandomState(3)
    for k in (1, 2, 3, 8):
        rows = (rng.standard_normal((k, 4097)) * np.exp(rng.uniform(-8, 8, (k, 4097)))).astype(np.float32)
        got = quantize.kahan_sum(torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref_quantize.kahan_sum(jnp.asarray(rows))))


@pytest.mark.parametrize("tier_size", [3, 4])
def test_int8_codes_of_a_tier_of_more_than_two_ranks(tier_size):
    """The in-tier partial sums ``tier_size`` ranks' float32 rows before the
    int8 encode. XLA adds them in rank order; torch.sum over dim 0 does not
    past a few rows, and a partial one ulp away could move its int8 code by
    a step. The port adds in rank order (``sync._rank_order_total``), so the
    partials, their codes and the synced values are the JAX package's bit
    for bit, here and for a tier of six."""
    from metrics_tpu_torch.parallel.sync import _rank_order_total

    rng = np.random.RandomState(tier_size)
    data = (rng.standard_normal((6, 700)) * np.exp(rng.uniform(-4, 4, (6, 700)))).astype(np.float32)
    for k in (tier_size, 6):
        got = _rank_order_total(torch.from_numpy(data[:k]))
        want = np.asarray(jnp.sum(jnp.asarray(data[:k]), axis=0))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(quantize.encode(got, "int8").numpy(),
                                      np.asarray(ref_quantize.encode(jnp.asarray(want), "int8")))

    def port_body(rank, w):
        return host_sync_state({"s": torch.from_numpy(data[rank])}, {"s": "sum"}, update_count=1, timeout=0,
                               sync_precision="int8")["s"].numpy()

    with _lockstep(6, tier_size) as w:
        got = w.run(lambda r: port_body(r, w))
    with ref_suite._lockstep(6, tier_size) as rw:
        want = rw.run(lambda r: np.asarray(ref_host_sync_state(
            {"s": jnp.asarray(data[r])}, {"s": "sum"}, update_count=1, timeout=0, sync_precision="int8")["s"]))
    for rank in range(6):
        np.testing.assert_array_equal(got[rank], want[rank])


@pytest.mark.parametrize("fused", [True, False])
def test_float_sums_over_ranks_add_in_rank_order(fused):
    """A float sum or mean over eight ranks equals the JAX package's bit for
    bit: XLA adds the ranks' rows in rank order (half precision accumulated
    in float32), which torch.sum's vectorized reduction does not past a few
    rows. The flat path, the tiered one and the per-leaf one agree."""
    rng = np.random.RandomState(8)
    data = (rng.standard_normal((WORLD, 300)) * np.exp(rng.uniform(-6, 6, (WORLD, 300)))).astype(np.float32)
    reds = {"s": "sum", "m": "mean", "h": "sum", "hm": "mean", "i": "mean"}

    def port_state(r):
        x = torch.from_numpy(data[r])
        return {"s": x, "m": x * 3, "h": x.to(torch.bfloat16), "hm": x.to(torch.float16),
                "i": torch.from_numpy((data[r] * 1000).astype(np.int32))}

    def ref_state(r):
        x = jnp.asarray(data[r])
        return {"s": x, "m": x * 3, "h": x.astype(jnp.bfloat16), "hm": x.astype(jnp.float16),
                "i": jnp.asarray((data[r] * 1000).astype(np.int32))}

    with ref_suite._lockstep(WORLD) as rw:
        want = rw.run(lambda r: state_bits(ref_host_sync_state(ref_state(r), reds, update_count=1, timeout=0,
                                                               fused=fused)))
    for tier_size in (None, 4):
        with _lockstep(WORLD, tier_size) as w:
            got = w.run(lambda r: state_bits(host_sync_state(port_state(r), reds, update_count=1, timeout=0,
                                                             fused=fused)))
        assert got == want, tier_size
