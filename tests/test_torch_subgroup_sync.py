"""In-program sync over process groups, against the JAX package.

Port twin of ``tests/parallel/test_subgroup_sync.py``,
``test_sequence_parallel.py`` and ``test_sharded_domains.py``. The JAX
package syncs over named axes of a device mesh inside ``shard_map``; the
port's ``pure_sync``/``sync_in_jit`` takes a ``torch.distributed`` group
(``parallel/sync.py``). Here every rank of the mesh is a thread of
``tests/helpers/torch_world.py``'s world: an 8-rank ``(dp=4, mp=2)`` world
whose ``world.axis("dp")`` is each rank's dp slice, rendezvous per group,
and every rank runs the port's real code. The expected values are the JAX
package's own, computed over the same numpy data: the values of each slice
for a one-axis sync, of all the data for a sync over every axis. Counts and
integer states compare exactly; float values within the stated atol.

Intended divergences, each a case below with its reason: the JAX package's
``process_group`` is a mesh-axis name, and a host sync over it raises (it
cannot sub-group its host collectives); the port's is a ``torch.distributed``
group, which its host sync honours (since PR 5), so ``sync()`` and
``compute()`` sync over the group instead of raising or warning. A
``lax.scan`` carry is a Python loop here.
"""
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.helpers.torch_world import TorchLockstepWorld

DP, MP = 4, 2
BATCH = 16
NUM_CLASSES = 3

rng = np.random.RandomState(55)
PREDS = rng.rand(DP, MP, BATCH, NUM_CLASSES).astype(np.float32)
TARGET = rng.randint(0, NUM_CLASSES, (DP, MP, BATCH))
BPREDS = rng.rand(DP, MP, BATCH).astype(np.float32)
BTARGET = np.tile((np.arange(BATCH) % 2)[None, None, :], (DP, MP, 1))


@pytest.fixture
def world2d(monkeypatch):
    world = TorchLockstepWorld(mesh=(("dp", DP), ("mp", MP))).install(monkeypatch)
    yield world
    world.shutdown_executors()


def _ref_value(make, preds, target):
    """The JAX package's value of one metric over ``preds``/``target``."""
    m = make()
    m.update(np.asarray(preds), np.asarray(target))
    return np.asarray(m.compute())


def _column(x, col):
    return x[:, col].reshape((-1,) + x.shape[3:])


def _port_acc(**kw):
    return port.Accuracy(num_classes=NUM_CLASSES, device="cpu", **kw)


def _warm(m):
    # as the JAX tests: latch the input mode eagerly before the pure calls
    m.update(torch.from_numpy(PREDS[0, 0]), torch.from_numpy(TARGET[0, 0]))
    m.reset()
    return m


def _shard(world, rank, x):
    c = world.coords(rank)
    return torch.from_numpy(x[c["dp"], c["mp"]])


# ---------------------------------------------------------------------------
# tests/parallel/test_subgroup_sync.py
# ---------------------------------------------------------------------------


def test_subgroup_sync_sum_states(world2d):
    """Accuracy synced over "dp" only: each mp column sees its own dp group."""

    def body(rank):
        m = _warm(_port_acc(process_group=world2d.axis("dp")))
        state = m.pure_update(m.init_state(), _shard(world2d, rank, PREDS), _shard(world2d, rank, TARGET))
        synced = m.pure_sync(state)  # no axis: the process_group
        return world2d.coords(rank)["mp"], state, synced, float(m.pure_compute(synced))

    out = world2d.run(body)
    for col in range(MP):
        want = _ref_value(lambda: ref.Accuracy(num_classes=NUM_CLASSES), _column(PREDS, col), _column(TARGET, col))
        got = [v for c, _l, _s, v in out if c == col]
        assert len(got) == DP and all(v == pytest.approx(float(want), abs=1e-6) for v in got)
        # the synced counts are the sums of the column's local counts, exactly
        local = [loc for c, loc, _s, _v in out if c == col]
        for c, _l, synced, _v in out:
            if c == col:
                for name, v in synced.items():
                    assert torch.equal(v, sum(x[name] for x in local)), name
    assert out[0][3] != out[1][3]  # the two columns are independent groups


def test_subgroup_sync_tuple_axes_equals_full(world2d):
    """A group spanning every axis is one global group: the full-data value."""

    def body(rank):
        m = _warm(_port_acc(process_group=world2d.axis("dp", "mp")))
        state = m.pure_update(m.init_state(), _shard(world2d, rank, PREDS), _shard(world2d, rank, TARGET))
        return float(m.pure_compute(m.pure_sync(state)))

    want = _ref_value(lambda: ref.Accuracy(num_classes=NUM_CLASSES), PREDS.reshape(-1, NUM_CLASSES), TARGET.reshape(-1))
    for v in world2d.run(body):
        assert v == pytest.approx(float(want), abs=1e-6)


def test_subgroup_sync_cat_states(world2d):
    """A CatBuffer's gather honours the group: per-column AUROC."""

    def body(rank):
        m = port.AUROC(process_group=world2d.axis("dp"), device="cpu").with_capacity(BATCH)
        m.update(torch.from_numpy(BPREDS[0, 0]), torch.from_numpy(BTARGET[0, 0]))
        m.reset()
        state = m.pure_update(m.init_state(), _shard(world2d, rank, BPREDS), _shard(world2d, rank, BTARGET))
        synced = m.pure_sync(state)
        assert synced["preds"].count == DP * BATCH and synced["preds"].capacity == DP * BATCH
        return world2d.coords(rank)["mp"], float(m.pure_compute(synced))

    out = world2d.run(body)
    for col in range(MP):
        want = _ref_value(lambda: ref.AUROC(), BPREDS[:, col].reshape(-1), BTARGET[:, col].reshape(-1))
        assert all(v == pytest.approx(float(want), abs=1e-6) for c, v in out if c == col)


def test_pure_forward_defaults_to_process_group(world2d):
    def body(rank):
        m = _warm(_port_acc(process_group=world2d.axis("dp")))
        _, value = m.pure_forward(m.init_state(), _shard(world2d, rank, PREDS), _shard(world2d, rank, TARGET))
        return world2d.coords(rank)["mp"], float(value)

    out = world2d.run(body)
    for col in range(MP):
        want = _ref_value(lambda: ref.Accuracy(num_classes=NUM_CLASSES), _column(PREDS, col), _column(TARGET, col))
        assert all(v == pytest.approx(float(want), abs=1e-6) for c, v in out if c == col)


def test_pure_sync_without_axis_or_group_raises():
    m = _port_acc()
    with pytest.raises(MetricsTPUUserError, match="mesh axis"):
        m.pure_sync(m.init_state())
    r = ref.Accuracy(num_classes=NUM_CLASSES)
    with pytest.raises(ref.utils.exceptions.MetricsTPUUserError, match="mesh axis"):
        r.pure_sync(r.init_state())


def test_host_sync_with_process_group_raises(world2d):
    """Divergence: the JAX package raises here (its host sync cannot
    sub-group); the port's host sync runs over the group, so ``sync()``
    gives each rank its dp slice's synced state, the state ``pure_sync``
    gives."""

    def body(rank):
        m = _port_acc(process_group=world2d.axis("dp"))
        m.update(_shard(world2d, rank, PREDS), _shard(world2d, rank, TARGET))
        piece = m.pure_sync({k: v for k, v in m._state.items()})
        m.sync()
        synced = {k: v.clone() for k, v in m._state.items()}
        m.unsync()
        return all(torch.equal(synced[k], piece[k]) for k in synced)

    assert all(world2d.run(body))
    m = ref.Accuracy(num_classes=NUM_CLASSES, process_group="dp")
    m.update(PREDS[0, 0], TARGET[0, 0])
    with pytest.raises(ref.utils.exceptions.MetricsTPUUserError, match="sub-group"):
        m.sync(distributed_available=lambda: True)


def test_collection_pure_forward_mixed_groups_per_member(world2d):
    """A group member syncs its step value over ITS group, a group-less one
    stays local, as each member's own pure_forward would."""

    def body(rank):
        mc = port.MetricCollection({"grouped": _port_acc(process_group=world2d.axis("dp")), "local": _port_acc()})
        mc.update(torch.from_numpy(PREDS[0, 0]), torch.from_numpy(TARGET[0, 0]))
        mc.reset()
        _, values = mc.pure_forward(mc.init_state(), _shard(world2d, rank, PREDS), _shard(world2d, rank, TARGET))
        return world2d.coords(rank), float(values["grouped"]), float(values["local"])

    out = world2d.run(body)
    make = lambda: ref.Accuracy(num_classes=NUM_CLASSES)  # noqa: E731
    for c, grouped, local in out:
        want_g = _ref_value(make, _column(PREDS, c["mp"]), _column(TARGET, c["mp"]))
        want_l = _ref_value(make, PREDS[c["dp"], c["mp"]], TARGET[c["dp"], c["mp"]])
        assert grouped == pytest.approx(float(want_g), abs=1e-6)
        assert local == pytest.approx(float(want_l), abs=1e-6)
    assert out[0][2] != out[2][2]  # the local member varies across dp rows


def test_host_compute_with_process_group_warns_not_raises(world2d):
    """Divergence: the JAX package skips the automatic host sync of a
    sub-group metric with a warning; the port's ``compute()`` syncs over the
    group, with no warning, and serves the dp slice's value."""
    import warnings

    def body(rank):
        m = _port_acc(process_group=world2d.axis("dp"))
        m.update(_shard(world2d, rank, PREDS), _shard(world2d, rank, TARGET))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            value = float(m.compute())
        return world2d.coords(rank)["mp"], value

    out = world2d.run(body)
    for col in range(MP):
        want = _ref_value(lambda: ref.Accuracy(num_classes=NUM_CLASSES), _column(PREDS, col), _column(TARGET, col))
        assert all(v == pytest.approx(float(want), abs=1e-6) for c, v in out if c == col)


def test_collection_pure_sync_mixed_groups(world2d):
    def body(rank):
        mc = port.MetricCollection({"grouped": _port_acc(process_group=world2d.axis("dp")), "local": _port_acc()})
        mc.update(torch.from_numpy(PREDS[0, 0]), torch.from_numpy(TARGET[0, 0]))
        mc.reset()
        state = mc.pure_update(mc.init_state(), _shard(world2d, rank, PREDS), _shard(world2d, rank, TARGET))
        values = mc.pure_compute(mc.pure_sync(state))
        return world2d.coords(rank), float(values["grouped"]), float(values["local"])

    make = lambda: ref.Accuracy(num_classes=NUM_CLASSES)  # noqa: E731
    for c, grouped, local in world2d.run(body):
        assert grouped == pytest.approx(float(_ref_value(make, _column(PREDS, c["mp"]), _column(TARGET, c["mp"]))),
                                        abs=1e-6)
        assert local == pytest.approx(float(_ref_value(make, PREDS[c["dp"], c["mp"]], TARGET[c["dp"], c["mp"]])),
                                      abs=1e-6)
    all_local = port.MetricCollection({"a": _port_acc()})
    with pytest.raises(MetricsTPUUserError, match="mesh axis"):
        all_local.pure_sync(all_local.init_state())


# ---------------------------------------------------------------------------
# tests/parallel/test_sequence_parallel.py
# ---------------------------------------------------------------------------

SDP, SP = 2, 4
SBATCH, SEQ, VOCAB = 4, 64, 11
srng = np.random.RandomState(3)
LOGITS = srng.rand(SDP * SBATCH, SEQ, VOCAB).astype(np.float32)
TOKENS = srng.randint(0, VOCAB, (SDP * SBATCH, SEQ))


@pytest.fixture
def world_sp(monkeypatch):
    world = TorchLockstepWorld(mesh=(("dp", SDP), ("sp", SP))).install(monkeypatch)
    yield world
    world.shutdown_executors()


def _seq_shard(world, rank, x):
    c = world.coords(rank)
    chunk = SEQ // SP
    return torch.from_numpy(np.ascontiguousarray(
        x[c["dp"] * SBATCH:(c["dp"] + 1) * SBATCH, c["sp"] * chunk:(c["sp"] + 1) * chunk]))


def test_token_accuracy_sequence_sharded(world_sp):
    """Batch over "dp", sequence over "sp": the sum over both axes equals the
    unsharded value."""

    def body(rank):
        m = port.Accuracy(num_classes=VOCAB, device="cpu")
        state = m.pure_update(m.init_state(), _seq_shard(world_sp, rank, LOGITS).reshape(-1, VOCAB),
                              _seq_shard(world_sp, rank, TOKENS).reshape(-1))
        return float(m.pure_compute(m.pure_sync(state, world_sp.axis("dp", "sp"))))

    want = _ref_value(lambda: ref.Accuracy(num_classes=VOCAB), LOGITS.reshape(-1, VOCAB), TOKENS.reshape(-1))
    for v in world_sp.run(body):
        assert v == pytest.approx(float(want), abs=1e-6)


def test_long_context_chunked_scan_matches_full():
    """A long sequence as a loop of chunk updates (the JAX package's
    ``lax.scan`` carry) accumulates to the one-shot value of both packages."""
    import jax
    import jax.numpy as jnp

    n_chunks, chunk = 16, 512
    logits = srng.rand(n_chunks * chunk, VOCAB).astype(np.float32)
    target = srng.randint(0, VOCAB, (n_chunks * chunk,))
    m = port.Accuracy(num_classes=VOCAB, device="cpu")
    m.update(torch.from_numpy(logits[:4]), torch.from_numpy(target[:4]))
    m.reset()
    state = m.init_state()
    for x, y in zip(torch.from_numpy(logits).reshape(n_chunks, chunk, VOCAB), torch.from_numpy(target).reshape(n_chunks, chunk)):
        state = m.pure_update(state, x, y)
    got = float(m.pure_compute(state))

    r = ref.Accuracy(num_classes=VOCAB)
    r.update(jnp.asarray(logits[:4]), jnp.asarray(target[:4]))
    r.reset()

    @jax.jit
    def stream(s0):
        return jax.lax.scan(lambda s, b: (r.pure_update(s, *b), None), s0,
                            (jnp.asarray(logits).reshape(n_chunks, chunk, VOCAB),
                             jnp.asarray(target).reshape(n_chunks, chunk)))[0]

    rstate = stream(r.init_state())
    assert got == pytest.approx(float(r.pure_compute(rstate)), abs=1e-7)
    assert int(state["correct"]) == int(rstate["correct"]) and int(state["total"]) == int(rstate["total"])


def test_collection_mixed_axis_sync_on_2d_mesh(world_sp):
    """KL divergence (sum states) synced over ("dp", "sp") jointly equals the
    unsharded value."""
    p = srng.rand(SDP * SBATCH, SEQ, VOCAB).astype(np.float32)
    p = p / p.sum(-1, keepdims=True)
    q = srng.rand(SDP * SBATCH, SEQ, VOCAB).astype(np.float32)
    q = q / q.sum(-1, keepdims=True)

    def body(rank):
        kl = port.KLDivergence(device="cpu")
        state = kl.pure_update(kl.init_state(), _seq_shard(world_sp, rank, p).reshape(-1, VOCAB),
                               _seq_shard(world_sp, rank, q).reshape(-1, VOCAB))
        return float(kl.pure_compute(kl.pure_sync(state, world_sp.axis("dp", "sp"))))

    want = _ref_value(lambda: ref.KLDivergence(), p.reshape(-1, VOCAB), q.reshape(-1, VOCAB))
    for v in world_sp.run(body):
        assert v == pytest.approx(float(want), rel=1e-5)


# ---------------------------------------------------------------------------
# tests/parallel/test_sharded_domains.py
# ---------------------------------------------------------------------------

N_BATCHES, ROWS, N_QUERIES = 10, 32, 17


def _strided(world, rank, n=N_BATCHES):
    return range(rank, n, world)


def _sharded_value(monkeypatch, world_n, make, batches, ref_make, ref_update=None):
    """Each rank pure-updates its rank-strided batches, syncs over the
    world's axis, computes; every rank's value against the JAX package's
    over all the batches."""
    world = TorchLockstepWorld(world_n).install(monkeypatch)

    def body(rank):
        m = make()
        state = m.init_state()
        for i in _strided(world_n, rank, len(batches)):
            args, kwargs = batches[i]
            state = m.pure_update(state, *(torch.from_numpy(a) for a in args),
                                  **{k: torch.from_numpy(v) for k, v in kwargs.items()})
        return float(m.pure_compute(m.pure_sync(state, world.axis("world"))))

    try:
        got = world.run(body)
    finally:
        world.shutdown_executors()
    r = ref_make()
    for args, kwargs in batches:
        (ref_update or r.update)(*args, **kwargs)
    return got, float(np.asarray(r.compute()))


def _retrieval_batches(nonbinary=False):
    rrng = np.random.RandomState(11)
    indexes = rrng.randint(0, N_QUERIES, (N_BATCHES, ROWS))
    preds = rrng.rand(N_BATCHES, ROWS).astype(np.float32)
    target = rrng.randint(0, 2, (N_BATCHES, ROWS))
    if nonbinary:
        target = np.random.RandomState(12).randint(0, 5, (N_BATCHES, ROWS))
    return [((preds[i], target[i]), {"indexes": indexes[i]}) for i in range(N_BATCHES)]


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalMRR"])
def test_sharded_ragged_groups(monkeypatch, name):
    got, want = _sharded_value(monkeypatch, 2, lambda: getattr(port, name)(device="cpu"), _retrieval_batches(),
                               lambda: getattr(ref, name)())
    assert all(v == pytest.approx(want, abs=1e-6) for v in got)


def test_sharded_ndcg_nonbinary(monkeypatch):
    got, want = _sharded_value(monkeypatch, 2, lambda: port.RetrievalNormalizedDCG(device="cpu"),
                               _retrieval_batches(nonbinary=True), lambda: ref.RetrievalNormalizedDCG())
    assert all(v == pytest.approx(want, abs=1e-6) for v in got)


@pytest.mark.parametrize("name", ["SNR", "SI_SDR"])
def test_sharded_ratio_metrics(monkeypatch, name):
    arng = np.random.RandomState(13)
    preds = arng.randn(N_BATCHES, ROWS, 100).astype(np.float32)
    target = arng.randn(N_BATCHES, ROWS, 100).astype(np.float32)
    batches = [((preds[i], target[i]), {}) for i in range(N_BATCHES)]
    got, want = _sharded_value(monkeypatch, 2, lambda: getattr(port, name)(device="cpu"), batches,
                               lambda: getattr(ref, name)())
    assert all(v == pytest.approx(want, abs=1e-3) for v in got)  # float32 log-domain sums, as the JAX test


def test_streaming_fid_psum_over_mesh(monkeypatch):
    """Streaming FID: per-rank moments, ONE in-program sum over four ranks,
    the value of all the data (the JAX package's), rtol 1e-4 as its test."""
    world_n, per_rank, batch = 4, 2, 8
    frng = np.random.RandomState(5)
    real = frng.rand(world_n * per_rank, batch, 3, 8, 8).astype(np.float32)
    fake = (frng.rand(world_n * per_rank, batch, 3, 8, 8) * 0.8 + 0.1).astype(np.float32)
    feat_port = lambda imgs: imgs.reshape(imgs.shape[0], -1)[:, :16]  # noqa: E731
    batches = [((real[i], True), {}) for i in range(world_n * per_rank)]
    batches += [((fake[i], False), {}) for i in range(world_n * per_rank)]
    world = TorchLockstepWorld(world_n).install(monkeypatch)

    def body(rank):
        fid = port.FID(feat_port, feature_dim=16, streaming=True, device="cpu")
        st = fid.init_state()
        for i in range(rank * per_rank, (rank + 1) * per_rank):
            st = fid.pure_update(st, torch.from_numpy(real[i]), real=True)
            st = fid.pure_update(st, torch.from_numpy(fake[i]), real=False)
        return float(fid.pure_compute(fid.pure_sync(st, world.axis("world"))))

    try:
        got = world.run(body)
    finally:
        world.shutdown_executors()
    r = ref.FID(feature=feat_port, feature_dim=16, streaming=True)
    for i in range(world_n * per_rank):
        r.update(real[i], real=True)
        r.update(fake[i], real=False)
    want = float(np.asarray(r.compute()))
    assert np.isfinite(want) and want > 0
    assert all(v == pytest.approx(want, rel=1e-4, abs=1e-4) for v in got)


CORPUS = [
    ("the quick brown fox", "the quick brown fox"),
    ("jumps over a lazy dog", "jumped over the lazy dog"),
    ("hello world again", "hello there world"),
    ("jax on tpu is fast", "jax on tpus is very fast"),
    ("metrics should sync", "metrics must sync"),
    ("one more sentence here", "one more sentences here"),
    ("short", "short"),
    ("the final pair of words", "a final pair of word"),
]


def _text_sharded(monkeypatch, make, update_one):
    """Per-rank eager updates over a corpus shard, one in-program sum over
    four ranks, the compute replicated: the text metrics' numeric states."""
    world_n = 4
    world = TorchLockstepWorld(world_n).install(monkeypatch)

    def body(rank):
        m = make()
        for i in range(rank, len(CORPUS), world_n):
            update_one(m, *CORPUS[i])
        return float(m.pure_compute(m.pure_sync(m._state, world.axis("world"))))

    try:
        return world.run(body)
    finally:
        world.shutdown_executors()


def test_wer_psum_equals_full_corpus(monkeypatch):
    got = _text_sharded(monkeypatch, lambda: port.WER(device="cpu"), lambda m, p, t: m.update(p, t))
    full = ref.WER()
    for p, t in CORPUS:
        full.update(p, t)
    assert all(v == pytest.approx(float(full.compute()), abs=1e-6) for v in got)


def test_bleu_psum_equals_full_corpus(monkeypatch):
    def upd(m, p, t):
        m.update([[t.split()]], [p.split()])

    got = _text_sharded(monkeypatch, lambda: port.BLEUScore(n_gram=2, device="cpu"), upd)
    full = ref.BLEUScore(n_gram=2)
    for p, t in CORPUS:
        upd(full, p, t)
    assert all(v == pytest.approx(float(full.compute()), abs=1e-6) for v in got)
