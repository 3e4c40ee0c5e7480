"""The port's durable checkpointer (``metrics_tpu_torch/core/checkpoint.py``).

Case for case with the eager cases of ``tests/bases/test_preemption_checkpoint.py``
(36) and ``tests/bases/test_elastic_resume.py`` (9), on the port, then the
files across the two packages:

- a file the JAX package writes (one module-scoped set, from one seeded set
  of numpy batches) loads into the port and computes the JAX value: int32
  counts into int64 states, a grouped collection's aliases, a CatBuffer with
  its overflow flag, retrieval list states, and bfloat16 ``set_dtype`` states;
  the text and audio families' float32 sums, PIT's int32 count, BERTScore's
  int32 token cat states and ROUGE's per-sentence cat lists;
- a file the port writes round-trips bit for bit (bfloat16 included), and
  the JAX loader refuses it with ``StateSchemaError`` naming
  ``int64 (saved) vs int32 (target)``.

Tolerances: states and counts compare exactly. Values computed from equal
states on the two packages: Accuracy and StatScores exactly (the same int
counts, one float32 division); macro Precision and Recall 1e-6 (a float32
mean over 10 classes summed in another order: log2(10) roundings of 2**-24,
2e-7); AUROC 1e-6 (the port ranks in exact integers,
the JAX package sums ranks in float32, ``test_torch_cat_buffer.py``); MAP
1e-6 (float32 sums of at most 24 terms per query in another order, each
term at most 1, then a mean over 6 queries: a few ulps of 1). MSE from equal
bfloat16 states is one bfloat16 division, equal bit for bit. The float16
``set_dtype`` case keeps the JAX test's 1e-2.
"""
import json
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu_torch import (
    AUROC,
    F1,
    Accuracy,
    Metric,
    MetricCollection,
    Precision,
    Recall,
    Specificity,
    load_checkpoint,
    save_checkpoint,
)
from metrics_tpu_torch.core.checkpoint import (
    _MIGRATIONS,
    MANIFEST_VERSION,
    available_steps,
    latest_step,
    prune_checkpoints,
    register_manifest_migration,
)
from metrics_tpu_torch.utils.exceptions import (
    CheckpointCorruptError,
    CheckpointError,
    MetricsTPUUserError,
    StateDictMismatchError,
    StateSchemaError,
)

CPU = dict(device="cpu")

rng = np.random.RandomState(4)
PREDS = rng.rand(10, 16, 10).astype(np.float32)
TARGET = rng.randint(0, 10, (10, 16))
BPREDS = rng.rand(10, 32).astype(np.float32)
BTARGET = rng.randint(0, 2, (10, 32))


def _acc(n: int = 10) -> Accuracy:
    return Accuracy(num_classes=n, **CPU)


def _prec(n: int = 10) -> Precision:
    return Precision(num_classes=n, average="macro", **CPU)


def _rec(n: int = 10) -> Recall:
    return Recall(num_classes=n, average="macro", **CPU)


def _feed(metric, idxs, preds=PREDS, target=TARGET):
    for i in idxs:
        metric.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    return metric


def _states(m):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in m._state.items()}


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------


def test_metric_roundtrip_resume(tmp_path):
    m = _feed(_acc(), range(5))
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    m2 = load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)
    assert m2._update_count == 5
    _feed(m2, range(5, 10))
    expected = (np.argmax(PREDS, -1) == TARGET).mean()
    np.testing.assert_allclose(float(m2.compute()), expected, atol=1e-6)


def test_collection_roundtrip_resume(tmp_path):
    mc = MetricCollection({"acc": _acc(), "prec": _prec()})
    _feed(mc, range(4))
    vals = {k: v.clone() for k, v in mc.compute().items()}
    save_checkpoint(mc, str(tmp_path), rank=0, world=1)
    mc2 = MetricCollection({"acc": _acc(), "prec": _prec()})
    load_checkpoint(mc2, str(tmp_path), rank=0, world=1)
    for k, v in mc2.compute().items():
        assert torch.equal(v, vals[k])
    assert mc2["acc"]._update_count == 4


def test_catbuffer_roundtrip_preserves_overflow_flag(tmp_path):
    m = AUROC(**CPU).with_capacity(64)
    m.update(torch.from_numpy(BPREDS[0]), torch.from_numpy(BTARGET[0]))
    m.preds.overflowed = True  # as a JAX snapshot that overflowed inside jit carries it
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    m2 = load_checkpoint(AUROC(**CPU).with_capacity(64), str(tmp_path), rank=0, world=1)
    assert m2.preds.overflowed
    with pytest.raises(MetricsTPUUserError, match="overflowed"):
        m2.preds.values()  # corruption stays loud after resume


def test_roundtrip_preserves_poison_flag(tmp_path):
    m = _acc().enable_check_finite()
    bad = PREDS[0].copy()
    bad[0, 0] = np.nan
    m.update(torch.from_numpy(bad), torch.from_numpy(TARGET[0]))
    assert int(m._nonfinite) == 1
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    m2 = load_checkpoint(_acc().enable_check_finite(), str(tmp_path), rank=0, world=1)
    assert int(m2._nonfinite) == 1  # still poisoned, still loud


def test_set_dtype_between_save_and_load(tmp_path):
    def warm(metric):
        # AUROC infers its input mode from the first update; warm + reset so
        # the restored metric can compute without a fresh batch
        metric.update(torch.from_numpy(BPREDS[1]), torch.from_numpy(BTARGET[1]))
        metric.reset()
        return metric

    m = AUROC(**CPU)
    m.update(torch.from_numpy(BPREDS[0]), torch.from_numpy(BTARGET[0]))
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    # the restore re-casts floating leaves to the target's declared dtype
    m2 = load_checkpoint(warm(AUROC(**CPU)).set_dtype(torch.float16), str(tmp_path), rank=0, world=1)
    assert all(x.dtype == torch.float16 for x in m2.preds)
    m3 = load_checkpoint(warm(AUROC(**CPU)), str(tmp_path), rank=0, world=1)
    np.testing.assert_allclose(float(m2.compute()), float(m3.compute()), atol=1e-2)


def test_to_device_between_save_and_load(tmp_path):
    m = _feed(_acc(), range(2))
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    m2 = _acc().to(torch.device("cpu"))
    load_checkpoint(m2, str(tmp_path), rank=0, world=1)
    assert torch.equal(m2.correct, m.correct) and m2.correct.device == m2.device


@pytest.mark.parametrize("save_grouped,load_grouped", [(True, False), (False, True)])
def test_grouped_ungrouped_collection_resume(tmp_path, save_grouped, load_grouped):
    def make(grouped):
        return MetricCollection({"p": _prec(), "r": _rec()}, compute_groups=grouped)

    mc = _feed(make(save_grouped), range(3))
    assert bool(mc.compute_group_keys) == save_grouped
    vals = {k: v.clone() for k, v in mc.compute().items()}
    save_checkpoint(mc, str(tmp_path), rank=0, world=1)
    mc2 = load_checkpoint(make(load_grouped), str(tmp_path), rank=0, world=1)
    for k, v in mc2.compute().items():
        assert torch.equal(v, vals[k])
    # a grouped loader re-forms its group from the bit-equal loaded states
    _feed(mc2, range(3, 5))
    assert bool(mc2.compute_group_keys) == load_grouped


def _manifest(path):
    blob = open(path, "rb").read()
    hlen, _ = struct.unpack_from("<QI", blob, 8)
    return json.loads(blob[20 : 20 + hlen])


def test_grouped_snapshot_stores_one_state_per_group(tmp_path):
    mc = MetricCollection({"p": _prec(), "r": _rec()})
    _feed(mc, range(2))
    assert mc.compute_group_keys  # grouped
    manifest = _manifest(save_checkpoint(mc, str(tmp_path), rank=0, world=1))
    recs = manifest["metrics"]
    with_states = [k for k, r in recs.items() if "states" in r]
    aliases = [k for k, r in recs.items() if "alias_of" in r]
    assert len(with_states) == 1 and len(aliases) == 1
    assert recs[aliases[0]]["alias_of"] == with_states[0]
    assert manifest["groups"]


# ---------------------------------------------------------------------------
# atomicity + crash injection
# ---------------------------------------------------------------------------


def test_crash_injection_truncate_and_bitflip_never_silent(tmp_path):
    """Mutate the snapshot at every sampled byte offset (stride 7, as the
    JAX test) — truncation and a bit flip — and assert the loader NEVER
    returns wrong state silently."""
    m = _feed(_acc(), range(3))
    path = save_checkpoint(m, str(tmp_path), rank=0, world=1)
    blob = open(path, "rb").read()
    reference = _states(m)
    caught = 0
    offsets = list(range(0, len(blob), 7)) + [len(blob) - 1]
    for off in offsets:
        truncated = blob[:off]
        flipped = blob[:off] + bytes([blob[off] ^ 0x10]) + blob[off + 1 :]
        for mutant in (truncated, flipped):
            with open(path, "wb") as f:
                f.write(mutant)
            fresh = _acc()
            try:
                load_checkpoint(fresh, str(tmp_path), step=0, rank=0, world=1)
            except (CheckpointCorruptError, CheckpointError):
                caught += 1
                continue
            # a load that "succeeded" must be value-identical to the original
            for k, v in reference.items():
                assert torch.equal(getattr(fresh, k), v)
    # truncations alone guarantee a majority of corrupt outcomes
    assert caught >= len(offsets)


def test_kill_during_save_leaves_previous_snapshot_loadable(tmp_path):
    m = _feed(_acc(), range(2))
    save_checkpoint(m, str(tmp_path), step=0, rank=0, world=1)
    # simulate a kill -9 mid-save of step 1: only the temp file exists
    step_dir = os.path.join(str(tmp_path), "step_0000000001")
    os.makedirs(step_dir)
    with open(os.path.join(step_dir, ".tmp-dead.mtck"), "wb") as f:
        f.write(b"half-written garbage")
    m2 = load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)
    assert m2._update_count == 2  # the previous complete snapshot


def test_incomplete_multirank_step_skipped(tmp_path):
    m = _feed(_acc(), range(2))
    for r in range(2):
        save_checkpoint(m, str(tmp_path), step=0, rank=r, world=2)
    # step 1: only rank 0's shard survived the preemption
    save_checkpoint(m, str(tmp_path), step=1, rank=0, world=2)
    with pytest.warns(RuntimeWarning, match="incomplete checkpoint step 1"):
        m2 = load_checkpoint(_acc(), str(tmp_path), rank=0, world=2)
    assert m2._update_count == 2
    with pytest.raises(CheckpointError, match="incomplete"):
        load_checkpoint(_acc(), str(tmp_path), step=1, rank=0, world=2)


def test_retention_prunes_old_complete_snapshots(tmp_path):
    m = _feed(_acc(), range(1))
    for step in range(5):
        save_checkpoint(m, str(tmp_path), step=step, rank=0, world=1, keep_last=2)
    assert available_steps(str(tmp_path)) == [3, 4]
    assert latest_step(str(tmp_path)) == 4
    with pytest.raises(MetricsTPUUserError):
        prune_checkpoints(str(tmp_path), keep_last=0)


def test_save_refuses_synced_state(tmp_path):
    m = _feed(_acc(), range(1))
    m._is_synced = True
    with pytest.raises(MetricsTPUUserError, match="PRE-sync"):
        save_checkpoint(m, str(tmp_path), rank=0, world=1)


def test_load_missing_directory_raises(tmp_path):
    with pytest.raises(CheckpointError, match="no complete checkpoint"):
        load_checkpoint(_acc(), str(tmp_path / "nope"), rank=0, world=1)


def test_load_refuses_synced_state(tmp_path):
    m = _feed(_acc(), range(1))
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    target = _feed(_acc(), range(1))
    target._is_synced = True
    with pytest.raises(MetricsTPUUserError, match="unsync"):
        load_checkpoint(target, str(tmp_path), rank=0, world=1)


def test_restore_invalidates_compute_cache(tmp_path):
    """compute() memoizes; a restore must supersede the cached value."""
    m = _feed(_acc(), range(4))
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    target = _feed(_acc(), range(1))
    stale = float(target.compute())  # memoized in _computed
    load_checkpoint(target, str(tmp_path), rank=0, world=1)
    expected = (np.argmax(PREDS[:4], -1) == TARGET[:4]).mean()
    assert float(target.compute()) != stale or stale == pytest.approx(expected)
    np.testing.assert_allclose(float(target.compute()), expected, atol=1e-6)
    # merge_state invalidates the cache too
    a, b = _feed(_acc(), range(1)), _feed(_acc(), [1])
    float(a.compute())
    a.merge_state(b)
    np.testing.assert_allclose(float(a.compute()), (np.argmax(PREDS[:2], -1) == TARGET[:2]).mean(), atol=1e-6)


# ---------------------------------------------------------------------------
# manifest versioning + migrations
# ---------------------------------------------------------------------------


def _rewrite_manifest(path, mutate):
    blob = open(path, "rb").read()
    hlen, _ = struct.unpack_from("<QI", blob, 8)
    manifest = json.loads(blob[20 : 20 + hlen])
    mutate(manifest)
    header = json.dumps(manifest, sort_keys=True, separators=(",", ":")).encode()
    with open(path, "wb") as f:
        f.write(
            b"MTPUCKPT"
            + struct.pack("<QI", len(header), zlib.crc32(header) & 0xFFFFFFFF)
            + header
            + blob[20 + hlen :]
        )


@pytest.fixture
def clean_migrations():
    saved = dict(_MIGRATIONS)
    _MIGRATIONS.clear()
    yield
    _MIGRATIONS.clear()
    _MIGRATIONS.update(saved)


def test_old_manifest_requires_migration(tmp_path, clean_migrations):
    m = _feed(_acc(), range(2))
    path = save_checkpoint(m, str(tmp_path), rank=0, world=1)
    _rewrite_manifest(path, lambda man: man.update(manifest_version=0))
    with pytest.raises(CheckpointError, match="no migration"):
        load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)

    def upgrade_v0(man):
        man = dict(man)
        man["manifest_version"] = MANIFEST_VERSION
        return man

    register_manifest_migration(0, upgrade_v0)
    m2 = load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)
    assert m2._update_count == 2


def test_newer_manifest_version_refused(tmp_path):
    m = _feed(_acc(), range(1))
    path = save_checkpoint(m, str(tmp_path), rank=0, world=1)
    _rewrite_manifest(path, lambda man: man.update(manifest_version=MANIFEST_VERSION + 1))
    with pytest.raises(CheckpointError, match="newer"):
        load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)


def test_non_advancing_migration_refused(tmp_path, clean_migrations):
    m = _feed(_acc(), range(1))
    path = save_checkpoint(m, str(tmp_path), rank=0, world=1)
    _rewrite_manifest(path, lambda man: man.update(manifest_version=0))
    register_manifest_migration(0, lambda man: man)  # does not bump the version
    with pytest.raises(CheckpointError, match="did not advance"):
        load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)


# ---------------------------------------------------------------------------
# schema validation on restore
# ---------------------------------------------------------------------------


def test_schema_mismatch_raises_before_mutation(tmp_path):
    m = _feed(_prec(), range(2))
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    target = _prec(5)
    target.update(torch.from_numpy(PREDS[0, :, :5]), torch.from_numpy(TARGET[0] % 5))
    before = _states(target)
    with pytest.raises(StateSchemaError, match="tp"):
        load_checkpoint(target, str(tmp_path), rank=0, world=1)
    for k, v in before.items():  # all-or-nothing: nothing mutated
        assert torch.equal(getattr(target, k), v)


def test_collection_key_mismatch_raises(tmp_path):
    mc = MetricCollection({"acc": _acc()})
    _feed(mc, range(1))
    save_checkpoint(mc, str(tmp_path), rank=0, world=1)
    with pytest.raises(StateSchemaError, match="missing.*unexpected"):
        load_checkpoint(MetricCollection({"other": _acc()}), str(tmp_path), rank=0, world=1)
    with pytest.raises(StateSchemaError, match="the target is a bare"):
        load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)


# ---------------------------------------------------------------------------
# auto-snapshot hook
# ---------------------------------------------------------------------------


def test_checkpointer_periodic_and_final_flush(tmp_path):
    m = _acc()
    with m.checkpointer(str(tmp_path), every_n_updates=3, keep_last=2, rank=0, world=1) as ck:
        _feed(m, range(8))
    # snapshots after updates 3 and 6, plus the exit flush at 8
    assert len(ck.snapshots) == 3
    assert available_steps(str(tmp_path)) == [1, 2]  # keep_last=2 pruned step 0
    m2 = load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)
    assert m2._update_count == 8
    expected = (np.argmax(PREDS[:8], -1) == TARGET[:8]).mean()
    np.testing.assert_allclose(float(m2.compute()), expected, atol=1e-6)


def test_checkpointer_forward_snapshots_merged_state(tmp_path):
    m = _acc()
    with m.checkpointer(str(tmp_path), every_n_updates=1, rank=0, world=1) as ck:
        m(torch.from_numpy(PREDS[0]), torch.from_numpy(TARGET[0]))
        m(torch.from_numpy(PREDS[1]), torch.from_numpy(TARGET[1]))
    assert len(ck.snapshots) == 2
    m2 = load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)
    expected = (np.argmax(PREDS[:2], -1) == TARGET[:2]).mean()
    np.testing.assert_allclose(float(m2.compute()), expected, atol=1e-6)


def test_checkpointer_on_collection(tmp_path):
    mc = MetricCollection({"p": _prec(), "r": _rec()})
    with mc.checkpointer(str(tmp_path), every_n_updates=2, rank=0, world=1) as ck:
        _feed(mc, range(4))
    assert len(ck.snapshots) == 2
    mc2 = MetricCollection({"p": _prec(), "r": _rec()})
    load_checkpoint(mc2, str(tmp_path), rank=0, world=1)
    want = mc.compute()
    for k, v in mc2.compute().items():
        assert torch.equal(v, want[k])


def test_checkpointer_multirank_steps_align(tmp_path):
    """Each rank's checkpointer numbers its n-th snapshot identically even
    when ranks enter the context at different times, so shards line up into
    complete, loadable steps."""
    for r in range(2):  # strictly sequential "ranks" — the worst skew
        m = _acc()
        with m.checkpointer(str(tmp_path), every_n_updates=2, rank=r, world=2):
            _feed(m, range(r, 6, 2))
    assert available_steps(str(tmp_path)) == [0, 1]  # 2 updates + the exit flush at 3
    m2 = load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)  # folds both shards
    assert m2._update_count == 6


def test_checkpointer_nesting_refused(tmp_path):
    m = _acc()
    with m.checkpointer(str(tmp_path), rank=0, world=1):
        with pytest.raises(MetricsTPUUserError, match="already has an active checkpointer"):
            with m.checkpointer(str(tmp_path), rank=0, world=1):
                pass


def test_checkpointer_invalid_interval(tmp_path):
    with pytest.raises(MetricsTPUUserError):
        _acc().checkpointer(str(tmp_path), every_n_updates=0)


# ---------------------------------------------------------------------------
# strict load_state_dict
# ---------------------------------------------------------------------------


def test_load_state_dict_default_still_skips_silently():
    m = _feed(_acc(), range(1))
    before = m.correct.clone()
    m.load_state_dict({})  # nothing happens — historical behavior
    assert torch.equal(m.correct, before)


def test_load_state_dict_strict_missing_and_unexpected():
    m = _acc()
    m.persistent(True)
    _feed(m, range(1))
    sd = m.state_dict()
    incomplete = {k: v for k, v in sd.items() if k != "correct"}
    incomplete["bogus"] = torch.zeros(())
    with pytest.raises(StateDictMismatchError) as err:
        _acc().load_state_dict(incomplete, strict=True)
    assert "correct" in str(err.value) and "bogus" in str(err.value)
    # and nothing was loaded before the raise
    fresh = _acc()
    with pytest.raises(StateDictMismatchError):
        fresh.load_state_dict(incomplete, strict=True)
    assert int(fresh.total) == 0
    _acc().load_state_dict(sd, strict=True)  # complete dict passes


def test_collection_load_state_dict_strict():
    mc = MetricCollection({"a": _acc(), "p": _prec()})
    mc.persistent(True)
    _feed(mc, range(1))
    sd = mc.state_dict()
    mc2 = MetricCollection({"a": _acc(), "p": _prec()})
    mc2.load_state_dict(sd, strict=True)  # a member's keys are not "unexpected"
    broken = dict(sd)
    broken.pop("a.correct")
    broken["stray.key"] = torch.zeros(())
    with pytest.raises(StateDictMismatchError) as err:
        mc2.load_state_dict(broken, strict=True)
    assert "a.correct" in str(err.value) and "stray.key" in str(err.value)


# ---------------------------------------------------------------------------
# merge_state schema validation
# ---------------------------------------------------------------------------


def test_merge_state_schema_mismatch_names_leaves():
    a = _feed(_prec(), range(1))
    b = _prec(5)
    b.update(torch.from_numpy(PREDS[0, :, :5]), torch.from_numpy(TARGET[0] % 5))
    with pytest.raises(StateSchemaError) as err:
        a.merge_state(b)
    assert "tp" in str(err.value)  # the divergent leaf is named


def test_merge_state_dict_missing_key():
    a = _feed(_acc(), range(1))
    with pytest.raises(StateSchemaError, match="missing"):
        a.merge_state({"correct": torch.zeros(())})


class _Cat(Metric):
    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("vals", [], dist_reduce_fx="cat")

    def update(self, x):
        self.vals.append(torch.as_tensor(x))

    def compute(self):
        return torch.cat([torch.atleast_1d(v) for v in self.vals])


def test_merge_state_cat_dtype_category_mismatch_refused():
    """Float rows into an int cat buffer would silently truncate — the
    validator refuses up front."""
    a = _Cat().with_capacity(16)
    a.update(torch.tensor([1, 2, 3], dtype=torch.int32))
    b = _Cat().with_capacity(16)
    b.update(torch.tensor([0.5, 0.25], dtype=torch.float32))
    with pytest.raises(StateSchemaError, match="dtype"):
        a.merge_state(b)
    # same-category precision moves stay legal promotion
    c = _Cat().with_capacity(16)
    c.update(torch.tensor([1.0, 2.0], dtype=torch.float16))
    b.merge_state(c)
    assert len(b.vals) == 4


def test_grouped_sibling_checkpointer_fires(tmp_path):
    """A checkpointer attached to a NON-leader grouped member must still
    snapshot under collection dispatch (the leader runs the shared update)."""
    mc = MetricCollection({"p": _prec(), "r": _rec()})
    _feed(mc, range(1))
    assert mc.compute_group_keys == [["p", "r"]]  # "p" is the leader
    with mc["r"].checkpointer(str(tmp_path), every_n_updates=1, rank=0, world=1) as ck:
        _feed(mc, [1])  # group update dispatches on "p"
        mc(torch.from_numpy(PREDS[2]), torch.from_numpy(TARGET[2]))  # group forward
    assert len(ck.snapshots) == 2
    m2 = load_checkpoint(_rec(), str(tmp_path), rank=0, world=1)
    assert torch.equal(m2.compute(), mc["r"].compute())


def test_merge_state_cross_kind_still_legal():
    # CatBuffer-mode and list-mode metrics merge across kinds (documented)
    a = AUROC(**CPU).with_capacity(128)
    b = AUROC(**CPU)
    a.update(torch.from_numpy(BPREDS[0]), torch.from_numpy(BTARGET[0]))
    b.update(torch.from_numpy(BPREDS[1]), torch.from_numpy(BTARGET[1]))
    a.merge_state(b)
    assert len(a.preds) == 64


def test_merge_state_identical_schema_unchanged():
    a = _feed(_acc(), range(1))
    b = _feed(_acc(), [1])
    a.merge_state(b)
    expected = (np.argmax(PREDS[:2], -1) == TARGET[:2]).mean()
    np.testing.assert_allclose(float(a.compute()), expected, atol=1e-6)


# ---------------------------------------------------------------------------
# elastic resume (tests/bases/test_elastic_resume.py)
# ---------------------------------------------------------------------------

erng = np.random.RandomState(7)
N_BATCH = 12
EPREDS = erng.rand(N_BATCH, 16, 5).astype(np.float32)
ETARGET = erng.randint(0, 5, (N_BATCH, 16))
EBPREDS = erng.rand(N_BATCH, 24).astype(np.float32)
EBTARGET = erng.randint(0, 2, (N_BATCH, 24))


def _stat_collection(grouped=True):
    k = dict(num_classes=5, average="macro", **CPU)
    return MetricCollection(
        {"prec": Precision(**k), "rec": Recall(**k), "f1": F1(**k), "spec": Specificity(**k)},
        compute_groups=grouped,
    )


def _efeed(metric, idxs, preds=EPREDS, target=ETARGET):
    return _feed(metric, idxs, preds, target)


def _merge_all(metrics):
    """Fold every rank's state into rank 0: the host-sync algebra."""
    head, *rest = metrics
    for other in rest:
        if isinstance(head, MetricCollection):
            for k in head.keys():
                if other[k]._update_count:
                    head[k].merge_state(other[k])
        elif other._update_count:
            head.merge_state(other)
    return head


@pytest.mark.parametrize("w_save,w_load", [(4, 2), (2, 4), (4, 3), (1, 3)])
def test_stat_collection_elastic_equals_uninterrupted(tmp_path, w_save, w_load):
    split = 8
    for r in range(w_save):
        mc = _efeed(_stat_collection(), range(r, split, w_save))
        save_checkpoint(mc, str(tmp_path), rank=r, world=w_save)
    resumed = []
    for r in range(w_load):
        mc = _stat_collection()
        load_checkpoint(mc, str(tmp_path), rank=r, world=w_load)
        _efeed(mc, [i for i in range(split, N_BATCH) if i % w_load == r])
        resumed.append(mc)
    # every shard's update count lands on exactly one rank
    assert sum(m["prec"]._update_count for m in resumed) == N_BATCH
    merged = _merge_all(resumed)
    uninterrupted = _efeed(_stat_collection(), range(N_BATCH))
    got = merged.compute()
    for k, v in uninterrupted.compute().items():
        assert torch.equal(got[k], v), k


def test_rank_strided_assignment(tmp_path):
    """W=4 -> W'=3: rank 0 folds shards 0 and 3, ranks 1/2 get one each."""
    for r in range(4):
        save_checkpoint(_efeed(Accuracy(num_classes=5, **CPU), [r]), str(tmp_path), rank=r, world=4)
    counts = [load_checkpoint(Accuracy(num_classes=5, **CPU), str(tmp_path), rank=r, world=3)._update_count
              for r in range(3)]
    assert counts == [2, 1, 1]
    # rank 0's folded state == shard 0 merged with shard 3, leaf for leaf
    m0 = load_checkpoint(Accuracy(num_classes=5, **CPU), str(tmp_path), rank=0, world=3)
    ref_m = _efeed(Accuracy(num_classes=5, **CPU), [0])
    ref_m.merge_state(_efeed(Accuracy(num_classes=5, **CPU), [3]))
    for k, v in ref_m._state.items():
        assert torch.equal(getattr(m0, k), v)


def test_scale_up_surplus_rank_restores_defaults(tmp_path):
    m = _efeed(Accuracy(num_classes=5, **CPU), range(2))
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    surplus = _efeed(Accuracy(num_classes=5, **CPU), range(3))  # stale pre-load state
    load_checkpoint(surplus, str(tmp_path), rank=2, world=3)
    assert surplus._update_count == 0
    assert int(surplus.correct.sum()) == 0
    assert not surplus._update_called


def test_catbuffer_curve_elastic_resume(tmp_path):
    split, w_save, w_load = 8, 4, 2

    def make():
        return AUROC(**CPU).with_capacity(N_BATCH * 24)

    for r in range(w_save):
        save_checkpoint(_efeed(make(), range(r, split, w_save), EBPREDS, EBTARGET), str(tmp_path), rank=r,
                        world=w_save)
    resumed = []
    for r in range(w_load):
        m = load_checkpoint(make(), str(tmp_path), rank=r, world=w_load)
        _efeed(m, [i for i in range(split, N_BATCH) if i % w_load == r], EBPREDS, EBTARGET)
        resumed.append(m)
    merged = _merge_all(resumed)
    # all rows present exactly once
    assert len(merged.preds) == N_BATCH * 24
    assert not merged.preds.overflowed
    uninterrupted = _efeed(make(), range(N_BATCH), EBPREDS, EBTARGET)
    assert torch.equal(merged.compute(), uninterrupted.compute())


def test_grouped_collection_elastic_resume_regroups(tmp_path):
    split, w_save, w_load = 6, 2, 3
    for r in range(w_save):
        mc = _efeed(_stat_collection(), range(r, split, w_save))
        assert mc.compute_group_keys  # saved grouped
        save_checkpoint(mc, str(tmp_path), rank=r, world=w_save)
    resumed = []
    for r in range(w_load):
        mc = _stat_collection()
        load_checkpoint(mc, str(tmp_path), rank=r, world=w_load)
        _efeed(mc, [i for i in range(split, N_BATCH) if i % w_load == r])
        # the loaded states are bit-equal across members, so the group
        # re-forms at the first post-resume dispatch
        assert mc.compute_group_keys == [["f1", "prec", "rec", "spec"]]
        resumed.append(mc)
    merged = _merge_all(resumed)
    uninterrupted = _efeed(_stat_collection(), range(N_BATCH))
    got = merged.compute()
    for k, v in uninterrupted.compute().items():
        assert torch.equal(got[k], v), k


def test_elastic_resume_into_ungrouped_collection(tmp_path):
    """A grouped 2-rank snapshot resumes into compute_groups=False loaders."""
    split = 6
    for r in range(2):
        save_checkpoint(_efeed(_stat_collection(grouped=True), range(r, split, 2)), str(tmp_path), rank=r, world=2)
    mc = _stat_collection(grouped=False)
    load_checkpoint(mc, str(tmp_path), rank=0, world=1)  # folds both shards
    _efeed(mc, range(split, N_BATCH))
    assert not mc.compute_group_keys
    uninterrupted = _efeed(_stat_collection(), range(N_BATCH))
    got = mc.compute()
    for k, v in uninterrupted.compute().items():
        assert torch.equal(got[k], v), k


class _Mean(Metric):
    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("avg", torch.zeros(()), dist_reduce_fx="mean")

    def update(self, x):
        self.avg = torch.as_tensor(x, dtype=torch.float32).mean()

    def compute(self):
        return self.avg


def test_non_mergeable_fold_refused_before_mutation(tmp_path):
    for r in range(2):
        m = _Mean()
        m.update(float(r + 1))
        save_checkpoint(m, str(tmp_path), rank=r, world=2)
    # same-world resume works (no fold needed)
    m_same = load_checkpoint(_Mean(), str(tmp_path), rank=1, world=2)
    assert float(m_same.compute()) == 2.0
    # scale-down needs a merge the "mean" reduction doesn't have: typed
    # refusal BEFORE any mutation
    target = _Mean()
    target.update(7.0)
    with pytest.raises(CheckpointError, match="no algebraic merge"):
        load_checkpoint(target, str(tmp_path), rank=0, world=1)
    assert float(target.avg) == 7.0


def test_fold_capacity_overflow_refused_before_mutation(tmp_path):
    def make():
        return AUROC(**CPU).with_capacity(32)  # one shard fits, two don't

    for r in range(2):
        m = make()
        m.update(torch.from_numpy(EBPREDS[r]), torch.from_numpy(EBTARGET[r]))  # 24 rows each
        save_checkpoint(m, str(tmp_path), rank=r, world=2)
    target = make()
    target.update(torch.from_numpy(EBPREDS[5]), torch.from_numpy(EBTARGET[5]))
    before = target.preds.buffer.clone()
    with pytest.raises(CheckpointError, match="with_capacity"):
        load_checkpoint(target, str(tmp_path), rank=0, world=1)
    assert torch.equal(target.preds.buffer, before)
    # each rank alone still fits — same-world resume unaffected
    load_checkpoint(make(), str(tmp_path), rank=0, world=2)


def test_same_world_resume_is_identity(tmp_path):
    for r in range(2):
        save_checkpoint(_efeed(Accuracy(num_classes=5, **CPU), range(r, 6, 2)), str(tmp_path), rank=r, world=2)
    for r in range(2):
        m = load_checkpoint(Accuracy(num_classes=5, **CPU), str(tmp_path), rank=r, world=2)
        ref_m = _efeed(Accuracy(num_classes=5, **CPU), range(r, 6, 2))
        for k, v in ref_m._state.items():
            assert torch.equal(getattr(m, k), v)
        assert m._update_count == ref_m._update_count


# ---------------------------------------------------------------------------
# files across the two packages
# ---------------------------------------------------------------------------

XRNG = np.random.RandomState(17)
XPREDS = XRNG.rand(3, 24, 10).astype(np.float32)
XTARGET = XRNG.randint(0, 10, (3, 24))
XBPREDS = XRNG.rand(3, 24).astype(np.float32)
XBTARGET = XRNG.randint(0, 2, (3, 24))
XIDX = XRNG.randint(0, 6, (3, 24))
XREG = XRNG.rand(3, 2, 24).astype(np.float32)


def _jax_cases():
    """name -> (JAX metric factory, port metric factory, feed(metric, to_array))."""

    def classify(m, arr):
        for i in range(3):
            m.update(arr(XPREDS[i]), arr(XTARGET[i]))

    def binary(m, arr):
        for i in range(3):
            m.update(arr(XBPREDS[i]), arr(XBTARGET[i]))

    def retrieval(m, arr):
        for i in range(3):
            m.update(arr(XBPREDS[i]), arr(XBTARGET[i]), indexes=arr(XIDX[i]))

    def regression(m, arr):
        for i in range(3):
            m.update(arr(XREG[i, 0]), arr(XREG[i, 1]))

    def group(pkg, **dev):
        return lambda: pkg.MetricCollection({
            "p": pkg.Precision(num_classes=10, average="macro", **dev),
            "r": pkg.Recall(num_classes=10, average="macro", **dev),
        })

    return {
        "accuracy": (lambda: ref.Accuracy(num_classes=10), lambda: port.Accuracy(num_classes=10, **CPU), classify),
        "stat_scores": (lambda: ref.StatScores(reduce="macro", num_classes=10),
                        lambda: port.StatScores(reduce="macro", num_classes=10, **CPU), classify),
        "grouped": (group(ref), group(port, **CPU), classify),
        "auroc_capacity": (lambda: ref.AUROC().with_capacity(96), lambda: port.AUROC(**CPU).with_capacity(96), binary),
        "retrieval_map": (lambda: ref.RetrievalMAP(), lambda: port.RetrievalMAP(**CPU), retrieval),
        "mse_bf16": (lambda: ref.MeanSquaredError().set_dtype(jnp.bfloat16),
                     lambda: port.MeanSquaredError(**CPU).set_dtype(torch.bfloat16), regression),
    }


ATOL = {"grouped": 1e-6, "auroc_capacity": 1e-6, "retrieval_map": 1e-6}


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """Each case's JAX metric fed the seeded batches, saved by the JAX
    package; its values computed after the save. The AUROC buffer also has a
    saved twin with the overflow flag set by hand."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    out = {}
    for name, (make_ref, _make_port, feed) in _jax_cases().items():
        m = make_ref()
        feed(m, jnp.asarray)
        ref.save_checkpoint(m, str(root / name), rank=0, world=1)
        value = m.compute()
        out[name] = {k: np.asarray(v) for k, v in value.items()} if isinstance(value, dict) else np.asarray(value)
    m = _jax_cases()["auroc_capacity"][0]()
    _jax_cases()["auroc_capacity"][2](m, jnp.asarray)
    m._state["preds"].overflowed = jnp.asarray(True)
    ref.save_checkpoint(m, str(root / "auroc_overflowed"), rank=0, world=1)
    return root, out


def _warm(name, m):
    """A fresh port metric that has seen one batch and been reset, as the
    JAX package's tests warm AUROC (its input mode latches at the first
    update)."""
    _jax_cases()[name][2](m, torch.from_numpy)
    m.reset()
    return m


@pytest.mark.parametrize("name", list(_jax_cases()))
def test_jax_written_file_loads_and_computes_the_jax_value(jax_files, name):
    root, values = jax_files
    want = values[name]
    make_port = _jax_cases()[name][1]
    m = load_checkpoint(_warm(name, make_port()), str(root / name), rank=0, world=1)
    got = m.compute()
    if isinstance(want, dict):
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, atol=ATOL["grouped"], rtol=0, err_msg=k)
    elif name in ATOL:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL[name])
    elif name == "mse_bf16":
        assert got.dtype == torch.bfloat16
        assert got.view(torch.int16).item() == int(np.asarray(want).view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_jax_int32_counts_widen_into_int64_states(jax_files):
    root, _ = jax_files
    manifest = _manifest(os.path.join(root / "accuracy", "step_0000000000", "shard_00000_of_00001.mtck"))
    assert {e["dtype"] for e in manifest["metrics"]["__metric__"]["states"].values()} == {"int32"}
    m = load_checkpoint(_warm("accuracy", port.Accuracy(num_classes=10, **CPU)), str(root / "accuracy"),
                        rank=0, world=1)
    assert all(v.dtype == torch.int64 for v in m._state.values())
    assert m._update_count == 3


def test_jax_grouped_file_carries_aliases_and_regroups(jax_files):
    root, want = jax_files
    path = os.path.join(root / "grouped", "step_0000000000", "shard_00000_of_00001.mtck")
    assert _manifest(path)["metrics"]["r"] == {**_manifest(path)["metrics"]["r"], "alias_of": "p"}
    mc = load_checkpoint(_jax_cases()["grouped"][1](), str(root / "grouped"), rank=0, world=1)
    _feed(mc, [0])
    assert mc.compute_group_keys == [["p", "r"]]


def test_jax_catbuffer_overflow_flag_survives_into_the_port(jax_files):
    root, _ = jax_files
    m = load_checkpoint(_warm("auroc_capacity", port.AUROC(**CPU).with_capacity(96)), str(root / "auroc_overflowed"),
                        rank=0, world=1)
    assert m.preds.overflowed and len(m.preds) == 72
    with pytest.raises(MetricsTPUUserError, match="overflowed"):
        m.preds.values()


def test_jax_bf16_state_loads_word_for_word(jax_files):
    root, _ = jax_files
    path = os.path.join(root / "mse_bf16", "step_0000000000", "shard_00000_of_00001.mtck")
    entry = _manifest(path)["metrics"]["__metric__"]["states"]["sum_squared_error"]
    assert entry["dtype"] == "bfloat16"
    jm = ref.load_checkpoint(ref.MeanSquaredError().set_dtype(jnp.bfloat16), str(root / "mse_bf16"), rank=0, world=1)
    m = load_checkpoint(port.MeanSquaredError(**CPU).set_dtype(torch.bfloat16), str(root / "mse_bf16"),
                        rank=0, world=1)
    assert m.sum_squared_error.dtype == torch.bfloat16
    words = np.asarray(jm._state["sum_squared_error"]).view(np.uint16)
    assert int(m.sum_squared_error.view(torch.int16).item()) & 0xFFFF == int(words)


def test_port_bf16_file_round_trips_bit_for_bit(tmp_path):
    m = port.MeanSquaredError(**CPU).set_dtype(torch.bfloat16)
    _jax_cases()["mse_bf16"][2](m, torch.from_numpy)
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    m2 = load_checkpoint(port.MeanSquaredError(**CPU).set_dtype(torch.bfloat16), str(tmp_path), rank=0, world=1)
    for k, v in m._state.items():
        got = getattr(m2, k)
        assert got.dtype == v.dtype and torch.equal(got.view(torch.int16) if v.dtype == torch.bfloat16 else got,
                                                    v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
    assert torch.equal(m2.compute(), m.compute())


@pytest.mark.parametrize("name", ["accuracy", "grouped", "retrieval_map", "auroc_capacity"])
def test_port_written_file_round_trips_bit_for_bit(tmp_path, name):
    _make_ref, make_port, feed = _jax_cases()[name]
    m = make_port()
    feed(m, torch.from_numpy)
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    m2 = load_checkpoint(_warm(name, make_port()), str(tmp_path), rank=0, world=1)
    pairs = zip(m.items(), m2.items()) if isinstance(m, MetricCollection) else [((0, m), (0, m2))]
    for (_, a), (_, b) in pairs:
        for k, v in a._state.items():
            w = getattr(b, k)
            if isinstance(v, list):
                assert len(v) == len(w) and all(torch.equal(x, y) and x.dtype == y.dtype for x, y in zip(v, w))
            elif isinstance(v, torch.Tensor):
                assert torch.equal(v, w) and v.dtype == w.dtype
            else:
                assert torch.equal(v.values(), w.values()) and v.capacity == w.capacity
    value, value2 = m.compute(), m2.compute()
    for k in value if isinstance(value, dict) else [None]:
        assert torch.equal(value[k] if k else value, value2[k] if k else value2)


TEXT_PREDS = ["the cat sat on the mat. it was happy!", "hello there general kenobi", "a b c d"]
TEXT_REFS = ["a cat sat on a mat. it was glad.", "hello there master kenobi", "a c d b"]
XAUDIO = np.random.RandomState(18).randn(3, 2, 4, 2, 32).astype(np.float32)
XEMB = np.random.RandomState(19).randn(30522, 8).astype(np.float32)


def _jax_text_cases():
    """name -> (JAX factory, port factory, feed(metric, to_array), states)
    for the text and audio families: float32 sums, int32 counts, int32
    token cat states and ROUGE's per-sentence cat lists."""

    def text(m, _arr):
        m.update(TEXT_PREDS, TEXT_REFS)

    def bleu(m, _arr):
        m.update([[r.split()] for r in TEXT_REFS], [p.split() for p in TEXT_PREDS])

    def audio(m, arr):
        for i in range(3):
            m.update(arr(XAUDIO[i, 0]), arr(XAUDIO[i, 1]))

    def jax_embed(input_ids, attention_mask):
        return jnp.asarray(XEMB)[input_ids]

    def port_embed(input_ids, attention_mask):
        return torch.from_numpy(XEMB)[input_ids.long()]

    from metrics_tpu.functional.audio import si_sdr as ref_si_sdr
    from metrics_tpu_torch.functional.audio import si_sdr as port_si_sdr

    return {
        "wer": (ref.WER, lambda: port.WER(**CPU), text, ("errors", "total")),
        "bleu": (ref.BLEUScore, lambda: port.BLEUScore(**CPU), bleu, ("numerator", "denominator", "trans_len", "ref_len")),
        "rouge": (lambda: ref.ROUGEScore(use_stemmer=True), lambda: port.ROUGEScore(use_stemmer=True, **CPU), text,
                  ("rouge1_fmeasure", "rougeLsum_recall")),
        "bertscore": (lambda: ref.BERTScore(model=jax_embed, max_length=16),
                      lambda: port.BERTScore(model=port_embed, max_length=16, **CPU), text,
                      ("preds_input_ids", "target_attention_mask")),
        "pit": (lambda: ref.PIT(ref_si_sdr), lambda: port.PIT(port_si_sdr, **CPU), audio, ("sum_pit_metric", "total")),
    }


# values from equal states: WER one float32 division (exact); BLEU float32
# log and exp (an ulp apart: 4 * 2**-24 relative); ROUGE means of 3 float32
# values; BERTScore greedy maxima of float32 cosines; PIT one float32 division
TEXT_RTOL = {"wer": 0.0, "bleu": 4 * 2.0 ** -24, "rouge": 4 * 2.0 ** -24, "bertscore": 1e-6, "pit": 1e-7}


@pytest.fixture(scope="module")
def jax_text_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_text_ckpt")
    out = {}
    for name, (make_ref, _make_port, feed, states) in _jax_text_cases().items():
        m = make_ref()
        feed(m, jnp.asarray)
        ref.save_checkpoint(m, str(root / name), rank=0, world=1)
        out[name] = (m.compute(), {k: getattr(m, k) for k in states})
    return root, out


@pytest.mark.parametrize("name", list(_jax_text_cases()))
def test_jax_text_and_audio_files_load_and_compute_the_jax_value(jax_text_files, name):
    root, values = jax_text_files
    want, want_states = values[name]
    m = load_checkpoint(_jax_text_cases()[name][1](), str(root / name), rank=0, world=1)
    for k, v in want_states.items():
        got = getattr(m, k)
        if isinstance(v, list):  # cat states: the JAX package's per-update arrays, as they were
            assert len(got) == len(v)
            for g, w in zip(got, v):
                assert g.dtype == {np.dtype("int32"): torch.int32, np.dtype("float32"): torch.float32}[np.asarray(w).dtype]
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            integer = np.issubdtype(np.asarray(v).dtype, np.integer)
            assert got.dtype == (torch.int64 if integer else torch.float32)  # int32 counts widen
            np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    got = m.compute()
    for k in want if isinstance(want, dict) else [None]:
        g, w = (got[k], want[k]) if k else (got, want)
        np.testing.assert_allclose(np.asarray(g, dtype=np.float64), np.asarray(w, dtype=np.float64),
                                   rtol=TEXT_RTOL[name], atol=1e-7 if name == "bertscore" else 0, err_msg=str(k))


def test_jax_loader_refuses_port_files(tmp_path):
    """Files cross one way only: the JAX package holds int32 counts, and its
    schema check refuses the port's int64 leaves."""
    m = port.Accuracy(num_classes=10, **CPU)
    _jax_cases()["accuracy"][2](m, torch.from_numpy)
    save_checkpoint(m, str(tmp_path), rank=0, world=1)
    target = ref.Accuracy(num_classes=10)
    with pytest.raises(ref.utils.exceptions.StateSchemaError, match=r"int64 \(saved\) vs int32 \(target\)"):
        ref.load_checkpoint(target, str(tmp_path), rank=0, world=1)


def test_port_refuses_narrowing_and_kind_changes(tmp_path):
    """Beyond the JAX package's float moves the port accepts only integer
    widening: int64 into int32 and bool into int stay divergent."""
    from metrics_tpu_torch.core.checkpoint import _dtype_compatible

    assert _dtype_compatible("int32", "int64") and _dtype_compatible("float32", "bfloat16")
    assert not _dtype_compatible("int64", "int32")
    assert not _dtype_compatible("bool", "int32") and not _dtype_compatible("uint8", "int64")
    assert not _dtype_compatible("float32", "int64")


def test_snapshots_refused_while_a_cuda_graph_is_captured(tmp_path, monkeypatch):
    """The JAX package refuses traced state; the port refuses a snapshot
    while the current stream captures a CUDA graph, and its checkpointer
    defers the due snapshot to the next update outside the capture."""
    from metrics_tpu_torch.core import checkpoint

    m = _feed(_acc(), range(1))
    monkeypatch.setattr(checkpoint, "_capturing", lambda: True)
    with pytest.raises(MetricsTPUUserError, match="CUDA graph"):
        save_checkpoint(m, str(tmp_path), rank=0, world=1)
    with m.checkpointer(str(tmp_path), every_n_updates=1, rank=0, world=1) as ck:
        _feed(m, [1])
        assert ck.snapshots == []
        monkeypatch.setattr(checkpoint, "_capturing", lambda: False)
        _feed(m, [2])
        assert len(ck.snapshots) == 1
    assert load_checkpoint(_acc(), str(tmp_path), rank=0, world=1)._update_count == 3
