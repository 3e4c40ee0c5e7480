"""The health-checked sync header of the port against the JAX package.

Each case makes one state per rank from numpy and builds both packages'
health words from it: every column but the schema hash (a CRC over each
package's own dtype names) is equal, and ``verify_health_words`` over the
gathered words raises the same exception class in both packages on every
rank, or passes in both. Then the watchdog, the channel-suspect latch, and
``check_finite`` screening against the JAX package's.
"""
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu.core.cat_buffer import CatBuffer as RefCatBuffer
from metrics_tpu.parallel import health as ref_health
from metrics_tpu.utils.exceptions import NonFiniteStateError as RefNonFiniteStateError
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.parallel import health
from metrics_tpu_torch.parallel.sync import host_sync_state
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, NonFiniteStateError, SyncError, SyncTimeoutError
from tests.helpers.torch_world import TorchLockstepWorld

WORLD = 2
SCHEMA_COLUMN = 1


@pytest.fixture(autouse=True)
def _healthy_channel():
    yield
    health.reset_channel_health()


# A state spec: name -> (kind, value, fx); kinds "leaf" (an array), "list"
# (a list of arrays) and "catbuf" ((capacity, [arrays], overflowed)).
def _clean(rank):
    rng = np.random.RandomState(rank)
    return {
        "tp": ("leaf", rng.randint(0, 9, 5).astype(np.int32), "sum"),
        "score": ("leaf", np.float32(rng.rand()), "sum"),
        "peak": ("leaf", rng.rand(3).astype(np.float32), "max"),
        "preds": ("list", [rng.rand(4 + rank).astype(np.float32), rng.rand(2).astype(np.float32)], "cat"),
        "rows": ("leaf", rng.rand(3 + rank, 2).astype(np.float32), "cat"),
        "buf": ("catbuf", (16, [rng.rand(3 + 2 * rank).astype(np.float32)], False), "cat"),
    }


def _empty_list(rank):
    spec = _clean(rank)
    if rank == 1:
        spec["preds"] = ("list", [], "cat")
    return spec


def _overflowed(rank):
    spec = _clean(rank)
    if rank == 0:
        cap, rows, _ = spec["buf"][1]
        spec["buf"] = ("catbuf", (cap, rows, True), "cat")
    return spec


def _num_classes(rank):
    spec = _clean(rank)
    spec["tp"] = ("leaf", np.zeros(5 + 2 * rank, np.int32), "sum")
    return spec


def _n_states(rank):
    spec = _clean(rank)
    if rank == 1:
        spec["extra"] = ("leaf", np.int32(1), "sum")
    return spec


def _poisoned(rank):
    spec = _clean(rank)
    spec[health.NONFINITE_STATE] = ("leaf", np.int32(0), "sum")
    if rank == 1:
        score = np.float32(np.nan)
        spec["score"] = ("leaf", score, "sum")
    return spec


def _many_states(rank):
    # 20 states: the tail past the 15th folds into the last count slot; its
    # one list state is empty on rank 1
    spec = {f"s{j:02d}": ("leaf", np.arange(3, dtype=np.int32) + rank, "sum") for j in range(19)}
    spec["zz_list"] = ("list", [] if rank == 1 else [np.ones(2, np.float32)], "cat")
    return spec


def _many_cat_states(rank):
    return {f"c{j:02d}": ("leaf", np.arange(j % 3 + 1 + rank, dtype=np.float32) + j, "cat") for j in range(18)}


CASES = {
    "clean": (_clean, (3, 3), False),
    "empty_cat_state": (_empty_list, (3, 3), False),
    "overflowed_catbuffer": (_overflowed, (3, 3), False),
    "num_classes_mismatch": (_num_classes, (3, 3), False),
    "n_states_mismatch": (_n_states, (3, 3), False),
    "update_count_skew_strict": (_clean, (3, 4), True),
    "update_count_skew_lenient": (_clean, (3, 4), False),
    "nan_poisoned": (_poisoned, (3, 3), False),
    "more_than_count_slots": (_many_states, (1, 1), False),
    "more_than_cat_length_slots": (_many_cat_states, (1, 1), False),
}


def _to_ref(spec):
    state, reds = {}, {}
    for name, (kind, value, fx) in spec.items():
        if kind == "leaf":
            state[name] = jnp.asarray(value)
        elif kind == "list":
            state[name] = [jnp.asarray(v) for v in value]
        else:
            cap, rows, overflowed = value
            cb = RefCatBuffer(cap)
            for r in rows:
                cb.append(jnp.asarray(r))
            cb.overflowed = jnp.asarray(overflowed)
            state[name] = cb
        reds[name] = fx
    return state, reds


def _to_port(spec):
    state, reds = {}, {}
    for name, (kind, value, fx) in spec.items():
        if kind == "leaf":
            state[name] = torch.as_tensor(np.asarray(value))
        elif kind == "list":
            state[name] = [torch.from_numpy(v) for v in value]
        else:
            cap, rows, overflowed = value
            cb = CatBuffer(cap)
            for r in rows:
                cb.append(torch.from_numpy(r))
            cb.overflowed = overflowed
            state[name] = cb
        reds[name] = fx
    return state, reds


def _verdict(verify, words, state, reds, strict):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            verify(words, state, reds, strict_update_count=strict, metric_name="case")
    except Exception as err:  # noqa: BLE001 - the class is compared
        return type(err).__name__
    return None


@pytest.mark.parametrize("case", list(CASES))
def test_health_words_match_the_reference(case, monkeypatch):
    # the JAX words' live_count column reads the process count
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    make, update_counts, strict = CASES[case]
    ref_words, port_words, states = [], [], []
    for rank in range(WORLD):
        spec = make(rank)
        ref_state, ref_reds = _to_ref(spec)
        port_state, port_reds = _to_port(spec)
        ref_words.append(np.asarray(ref_health.build_health_word(ref_state, ref_reds, update_count=update_counts[rank])))
        port_words.append(health.build_health_word(port_state, port_reds, update_counts[rank], world=WORLD))
        states.append(((ref_state, ref_reds), (port_state, port_reds)))
    ref_words, port_words = np.stack(ref_words), np.stack(port_words)
    assert port_words.shape == ref_words.shape == (WORLD, health.WORD_WIDTH)
    assert port_words.dtype == np.int32
    others = [c for c in range(health.WORD_WIDTH) if c != SCHEMA_COLUMN]
    np.testing.assert_array_equal(port_words[:, others], ref_words[:, others])
    # the hash differs between ranks exactly when the reference's does
    assert (port_words[0, SCHEMA_COLUMN] == port_words[1, SCHEMA_COLUMN]) == (
        ref_words[0, SCHEMA_COLUMN] == ref_words[1, SCHEMA_COLUMN])
    for rank, ((ref_state, ref_reds), (port_state, port_reds)) in enumerate(states):
        want = _verdict(ref_health.verify_health_words, ref_words, ref_state, ref_reds, strict)
        got = _verdict(health.verify_health_words, port_words, port_state, port_reds, strict)
        assert got == want, (case, rank)


def test_cases_cover_every_verdict():
    verdicts = set()
    for case, (make, update_counts, strict) in CASES.items():
        words = np.stack([health.build_health_word(*_to_port(make(r)), update_counts[r], world=WORLD)
                          for r in range(WORLD)])
        verdicts.add(_verdict(health.verify_health_words, words, *_to_port(make(0)), strict))
    assert verdicts == {None, "StateDivergenceError", "SyncError", "NonFiniteStateError"}


def test_schema_parts_name_the_port_dtypes():
    state, reds = _to_port(_clean(0))
    parts = health.state_schema_parts(state, reds)
    assert "tp|leaf|int32(5,)|sum" in parts and "rows|leaf|float32(2,)|cat" in parts
    assert "buf|catbuf|float32()|cat" in parts
    assert health.state_schema_hash(state, reds) == health.state_schema_hash(*_to_port(_clean(1)))


def test_watchdog_raises_on_a_stalled_call_and_latches_the_channel(monkeypatch):
    release = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(SyncTimeoutError, match="did not complete within 0.2s"):
        health.call_with_sync_watchdog(lambda: release.wait(5.0), timeout=0.2, what="stalled gather")
    assert time.monotonic() - t0 < 1.0
    release.set()
    assert health.channel_is_suspect()
    # the next sync refuses before issuing any collective
    world = TorchLockstepWorld(WORLD).install(monkeypatch)
    state, reds = _to_port(_clean(0))
    with pytest.raises(SyncTimeoutError, match="refused"):
        host_sync_state(state, reds)
    assert world.calls == 0
    # and a metric degrades on it under on_error="local"
    m = port.Precision(num_classes=5, average="macro", device="cpu")
    m.update(torch.rand(8, 5), torch.randint(0, 5, (8,)))
    with pytest.warns(RuntimeWarning, match="LOCAL-ONLY"):
        m.sync(on_error="local")
    assert not m._is_synced and m._sync_degraded
    m.unsync()  # a no-op after a degraded sync
    health.reset_channel_health()
    assert not health.channel_is_suspect()


def test_watchdog_passes_results_and_errors_through():
    assert health.call_with_sync_watchdog(lambda: 7, timeout=5.0) == 7
    with pytest.raises(ValueError, match="inner"):
        health.call_with_sync_watchdog(lambda: (_ for _ in ()).throw(ValueError("inner")), timeout=5.0)
    assert not health.channel_is_suspect()


class _Sum(port.Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


def test_on_missing_quorum_waits_for_its_slice():
    """Quorum landed with its slice (``parallel/resilience.py``): accepted
    over the default world, refused with another process group; an unknown
    policy raises as before."""
    assert _Sum(sync_on_missing="quorum").sync_on_missing == "quorum"
    with pytest.raises(MetricsTPUUserError, match="default torch.distributed world"):
        _Sum(sync_on_missing="quorum", process_group=[0, 1])
    with pytest.raises(MetricsTPUUserError, match="on_error"):
        _Sum(sync_on_error="ignore")
    with pytest.raises(MetricsTPUUserError, match="on_missing"):
        _Sum(sync_on_missing="shrink")
    m = port.Precision(num_classes=5, device="cpu", process_group=[0, 1])
    with pytest.raises(MetricsTPUUserError, match="default torch.distributed world"):
        m.sync(on_missing="quorum", distributed_available=lambda: True)


def _check_finite_pair(nan):
    rng = np.random.RandomState(5)
    preds = rng.rand(32, 4).astype(np.float32)
    target = rng.randint(0, 4, 32)
    if nan:
        preds[3, 1] = np.nan
    m_ref = ref.Precision(num_classes=4, average="macro").enable_check_finite()
    m_port = port.Precision(num_classes=4, average="macro", device="cpu").enable_check_finite()
    m_ref.update(jnp.asarray(preds), jnp.asarray(target))
    m_port.update(torch.from_numpy(preds), torch.from_numpy(target))
    return m_ref, m_port


@pytest.mark.parametrize("nan", [False, True], ids=["clean", "nan"])
def test_check_finite_matches_the_reference(nan):
    m_ref, m_port = _check_finite_pair(nan)
    assert int(m_port._nonfinite) == int(np.asarray(m_ref._state["_nonfinite"])) == int(nan)
    assert health.state_poisoned(m_port._state) == nan
    if nan:
        with pytest.raises(RefNonFiniteStateError):
            m_ref.compute()
        with pytest.raises(NonFiniteStateError):
            m_port.compute()
    else:
        np.testing.assert_allclose(float(m_port.compute()), float(m_ref.compute()), rtol=0, atol=1e-6)


def test_check_finite_must_come_before_the_first_update():
    m = port.Precision(num_classes=4, device="cpu")
    m.update(torch.rand(4, 4), torch.randint(0, 4, (4,)))
    with pytest.raises(MetricsTPUUserError, match="before the first"):
        m.enable_check_finite()
    assert issubclass(NonFiniteStateError, SyncError) and issubclass(SyncTimeoutError, SyncError)


def _custom_sum(gathered):
    return gathered.sum(0)


def test_fingerprint_crc_is_durable_across_callable_identities():
    def fingerprint(c, fx):
        m = _Sum()
        m.add_state("per_class", torch.zeros(c, dtype=torch.long), dist_reduce_fx=fx)
        return m.state_fingerprint()

    a, b = fingerprint(5, _custom_sum), fingerprint(5, lambda g: g.sum(0))
    assert a != b  # in process, callables compare by identity
    assert health.fingerprint_crc(a) == health.fingerprint_crc(b)
    assert health.fingerprint_crc(fingerprint(5, "sum")) != health.fingerprint_crc(fingerprint(6, "sum"))
    assert 0 <= health.fingerprint_crc(a) < 2**31
