"""The port's bucketed host sync against the JAX package's, on two ranks.

Both packages run their real sync code on two threads with rendezvous
collectives: the JAX package under ``tests/helpers/fake_world.py``'s
``LockstepWorld``, the port under ``tests/helpers/torch_world.py``'s
``TorchLockstepWorld`` (on its ``_all_gather`` seam). The state is the mixed
state of ``tests/parallel/test_bucketed_sync.py`` (every leaf family at once,
uneven rows), made per rank from numpy. Synced values are equal, exactly:
integers, and float sums of two terms, which both packages round once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.parallel.sync as ref_sync
import metrics_tpu_torch as port
from metrics_tpu.core.cat_buffer import CatBuffer as RefCatBuffer
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.parallel.bucketing import (
    build_sync_plan,
    clear_sync_plan_cache,
    fused_sync_enabled,
    sync_plan_cache_info,
)
from metrics_tpu_torch.parallel.health import CAT_LENGTH_SLOTS
from metrics_tpu_torch.parallel.sync import host_sync_state
from metrics_tpu_torch.utils.exceptions import StateDivergenceError
from tests.helpers.fake_world import LockstepWorld
from tests.helpers.torch_world import TorchLockstepWorld

WORLD = 2


@pytest.fixture(autouse=True)
def _fresh_plan_cache():
    clear_sync_plan_cache()
    yield
    clear_sync_plan_cache()


@pytest.fixture
def world(monkeypatch):
    return TorchLockstepWorld(WORLD).install(monkeypatch)


def _ref_custom_fx(gathered):
    return jnp.sum(gathered, axis=0) * 2.0


def _port_custom_fx(gathered):
    return torch.sum(gathered, dim=0) * 2.0


def _mixed_numpy(rank):
    """name -> (kind, value, fx): the uneven, mixed-dtype, mixed-fx state."""
    f32, i32 = np.float32, np.int32
    return {
        "sum_f32": ("leaf", (np.asarray([[1.5, 2.5], [3.5, 4.5]]) * (rank + 1)).astype(f32), "sum"),
        "sum_scalar": ("leaf", f32(2.0 + rank), "sum"),
        "sum_i32": ("leaf", np.asarray([2, 3], i32) + rank, "sum"),
        "mean_f32": ("leaf", (np.asarray([0.25, 0.75]) + rank).astype(f32), "mean"),
        "max_f32": ("leaf", np.asarray([[1.0 + 3 * rank, 2.0], [5.0, 4.0 - rank]], f32), "max"),
        "min_i32": ("leaf", i32(5 - 2 * rank), "min"),
        "cat_f32": ("leaf", np.arange(3 + rank, dtype=f32) + 10.0 * rank, "cat"),
        "cat_2d": ("leaf", np.arange(2 * (2 - rank), dtype=f32).reshape(2 - rank, 2) - rank, "cat"),
        "cat_i32": ("leaf", np.arange(4 - rank, dtype=i32) + 20 * rank, "cat"),
        "none_scalar": ("leaf", f32(7.0 + rank), None),
        "lst": ("list", [(np.asarray([1.0, 2.0]) + rank).astype(f32), f32(3.0 + rank)], "cat"),
        "buf": ("catbuf", (16, np.arange(3 + 2 * rank, dtype=f32) + 100.0 * rank), "cat"),
        "ibuf": ("catbuf", (8, np.asarray([[1 + rank, 2], [3, 4 + rank]], i32)[: 1 + rank]), "cat"),
        "cust": ("leaf", np.asarray([1.0 + rank, 2.0], f32), "custom"),
    }


def _state(spec, package):
    state, reds = {}, {}
    for name, (kind, value, fx) in spec.items():
        if package == "ref":
            if kind == "leaf":
                state[name] = jnp.asarray(value)
            elif kind == "list":
                state[name] = [jnp.asarray(v) for v in value]
            else:
                state[name] = RefCatBuffer(value[0]).append(jnp.asarray(value[1]))
            reds[name] = _ref_custom_fx if fx == "custom" else fx
        else:
            if kind == "leaf":
                state[name] = torch.as_tensor(np.asarray(value))
            elif kind == "list":
                state[name] = [torch.as_tensor(np.asarray(v)) for v in value]
            else:
                state[name] = CatBuffer(value[0]).append(torch.from_numpy(value[1]))
            reds[name] = _port_custom_fx if fx == "custom" else fx
    return state, reds


def _np_leaf(v):
    """A synced leaf as plain numpy: CatBuffer -> (capacity, rows)."""
    if isinstance(v, (CatBuffer, RefCatBuffer)):
        return ("catbuf", (v.capacity, int(np.asarray(v.count))), np.asarray(v.values()))
    if isinstance(v, list):
        return [np.asarray(x) for x in v]
    return np.asarray(v)


def _assert_leaf_equal(got, want, name):
    if isinstance(want, tuple):
        assert got[:2] == want[:2], name
        got, want = got[2], want[2]
    if isinstance(want, list):
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _assert_leaf_equal(g, w, name)
        return
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), name


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_leaf_equal(_np_leaf(got[name]), _np_leaf(want[name]), name)


def _run_port(world, fused, state_fn=_mixed_numpy):
    world.calls = 0

    def body(rank):
        state, reds = _state(state_fn(rank), "port")
        return host_sync_state(state, reds, update_count=3, fused=fused)

    return world.run(body), world.calls


@pytest.fixture(scope="module")
def reference_results():
    """The JAX package's fused sync of the mixed state on its lockstep world,
    and its collective count."""
    ref_world = LockstepWorld(WORLD)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "process_count", lambda: ref_world.world)
        mp.setattr(ref_sync, "_raw_process_allgather", ref_world.allgather)

        def body(rank):
            state, reds = _state(_mixed_numpy(rank), "ref")
            return ref_sync.host_sync_state(state, reds, update_count=3, timeout=0, fused=True)

        results = ref_world.run(body)
    return results, ref_world.calls


def test_fused_sync_equals_the_reference(world, reference_results):
    want, _ = reference_results
    got, _ = _run_port(world, fused=True)
    for rank in range(WORLD):
        _assert_states_equal(got[rank], want[rank])


def test_fused_sync_issues_as_many_collectives_as_the_reference(world, reference_results):
    _, ref_calls = reference_results
    _, fused_calls = _run_port(world, fused=True)
    _, per_leaf_calls = _run_port(world, fused=False)
    plan = build_sync_plan(*_state(_mixed_numpy(0), "port"))
    # one header, one collective per bucket, and the callable leaf's gather
    assert fused_calls == ref_calls == 1 + plan.n_buckets + len(plan.fallback)
    assert fused_calls < len(_mixed_numpy(0)) < per_leaf_calls


def test_fused_equals_per_leaf_bit_for_bit(world):
    fused, _ = _run_port(world, fused=True)
    per_leaf, _ = _run_port(world, fused=False)
    for rank in range(WORLD):
        _assert_states_equal(fused[rank], per_leaf[rank])
    _assert_states_equal(fused[0], fused[1])


def test_fused_merges_uneven_rows_in_rank_order(world):
    out = _run_port(world, fused=True)[0][0]
    np.testing.assert_array_equal(out["cat_f32"].numpy(), np.r_[np.arange(3), np.arange(4) + 10.0].astype(np.float32))
    assert len(out["buf"]) == 3 + 5 and out["buf"].capacity == WORLD * 16
    assert len(out["lst"]) == WORLD and out["lst"][0].shape == (3,)
    np.testing.assert_array_equal(out["cust"].numpy(), np.asarray([3.0, 4.0], np.float32) * 2.0)
    assert out["mean_f32"].dtype == torch.float32 and out["sum_i32"].dtype == torch.int32


def test_plan_cache_hits_on_a_repeated_schema(world):
    _run_port(world, fused=True)
    info = sync_plan_cache_info()
    assert info["size"] == 1 and info["misses"] >= 1
    _run_port(world, fused=True)
    again = sync_plan_cache_info()
    assert again["size"] == 1 and again["misses"] == info["misses"] and again["hits"] == info["hits"] + WORLD
    # uneven leading dims of cat states are not part of the schema
    assert build_sync_plan(*_state(_mixed_numpy(0), "port")) is build_sync_plan(*_state(_mixed_numpy(1), "port"))


def test_beyond_the_length_slots_one_length_vector_is_gathered(world):
    n = CAT_LENGTH_SLOTS + 2

    def big(rank):
        return {f"c{j:02d}": ("leaf", np.arange(j % 3 + 1 + rank, dtype=np.float32) + j, "cat") for j in range(n)}

    fused, fused_calls = _run_port(world, fused=True, state_fn=big)
    per_leaf, _ = _run_port(world, fused=False, state_fn=big)
    _assert_states_equal(fused[0], per_leaf[0])
    assert fused_calls == 3  # the header, the length vector, one float32 bucket


def test_fused_knob_reads_the_environment(monkeypatch):
    assert fused_sync_enabled()
    monkeypatch.setenv("METRICS_TPU_FUSED_SYNC", "0")
    assert not fused_sync_enabled()


@pytest.mark.parametrize("shapes", [("macro", 10, "macro", 12), ("micro", 10, "macro", 10)],
                         ids=["num_classes", "state_rank"])
def test_schema_divergent_ranks_raise_state_divergence_on_every_rank(world, shapes):
    """Ranks that disagree on ``num_classes``, or on a state's rank, raise
    the same StateDivergenceError before any payload moves."""

    def body(rank):
        reduce, c = shapes[2 * rank], shapes[2 * rank + 1]
        m = port.StatScores(reduce=reduce, num_classes=c, device="cpu")
        m.update(torch.rand(16, c), torch.randint(0, c, (16,)))
        return m.compute()

    world.calls = 0
    assert world.run_catching(body) == [StateDivergenceError] * WORLD
    assert world.calls == 1  # the header alone
