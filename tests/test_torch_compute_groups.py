"""Compute groups of the port's ``MetricCollection``, and its grouped sync.

The cases of ``tests/bases/test_compute_groups.py`` (without the pure/compiled
ones) on the port: schema- and update-identical members run one update per
step and hold one copy of state, with every result the same bits as the
ungrouped collection; a stray mutation of one member copies its state and
takes it out of the group. ``compute_group_keys`` equals the JAX package's
for the same members. Then the grouped-sync cases of
``tests/parallel/test_grouped_sync.py`` on two ranks on threads
(``tests/helpers/torch_world.py``).
"""
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
import metrics_tpu_torch.classification.stat_scores as stat_scores_mod
import metrics_tpu_torch.parallel.sync as sync_mod
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.collections import COMPUTE_GROUPS_ENV, compute_groups_enabled
from metrics_tpu_torch.parallel.bucketing import clear_sync_plan_cache
from metrics_tpu_torch.utils.exceptions import (
    MetricsTPUUserError,
    NonFiniteStateError,
    StateDivergenceError,
)
from tests.helpers.torch_world import TorchLockstepWorld

rng = np.random.RandomState(7)
PREDS = [torch.from_numpy(rng.rand(48, 5).astype(np.float32)) for _ in range(3)]
TARGET = [torch.from_numpy(rng.randint(0, 5, (48,))) for _ in range(3)]
BPREDS = [torch.from_numpy(rng.rand(40).astype(np.float32)) for _ in range(3)]
BTARGET = [torch.from_numpy(rng.randint(0, 2, (40,))) for _ in range(3)]
CPU = dict(device="cpu")
WORLD = 2


def _stat_collection(**kwargs):
    return port.MetricCollection(
        {
            "prec": port.Precision(num_classes=5, average="macro", **CPU),
            "rec": port.Recall(num_classes=5, average="macro", **CPU),
            "f1": port.F1(num_classes=5, average="macro", **CPU),
            "spec": port.Specificity(num_classes=5, average="macro", **CPU),
        },
        **kwargs,
    )


def _curve_collection(capacity=None, **kwargs):
    ms = {"roc": port.ROC(pos_label=1, **CPU), "prc": port.PrecisionRecallCurve(pos_label=1, **CPU),
          "ap": port.AveragePrecision(pos_label=1, **CPU)}
    if capacity:
        for m in ms.values():
            m.with_capacity(capacity)
    return port.MetricCollection(ms, **kwargs)


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or (x.is_floating_point() and bool(torch.equal(x.isnan(), y.isnan()))
                                     and torch.equal(x.nan_to_num(), y.nan_to_num()))


# ---------------------------------------------------------------------------
# group formation, against the JAX package's
# ---------------------------------------------------------------------------

def _collections(pkg, dev):
    k = dict(device="cpu") if dev else {}
    return {
        "report": lambda: pkg.MetricCollection({
            "prec": pkg.Precision(num_classes=5, average="macro", **k),
            "rec": pkg.Recall(num_classes=5, average="macro", **k),
            "f1": pkg.F1(num_classes=5, average="macro", **k),
            "spec": pkg.Specificity(num_classes=5, average="macro", **k),
            "confmat": pkg.ConfusionMatrix(5, normalize="true", **k),
            "mcc": pkg.MatthewsCorrcoef(5, **k),
            "kappa": pkg.CohenKappa(5, **k),
            "hamming": pkg.HammingDistance(**k),
        }),
        "curve_family": lambda: pkg.MetricCollection({
            "roc": pkg.ROC(pos_label=1, **k), "prc": pkg.PrecisionRecallCurve(pos_label=1, **k),
            "ap": pkg.AveragePrecision(pos_label=1, **k), "ap_micro": pkg.AveragePrecision(pos_label=1, average="micro", **k),
            "auroc": pkg.AUROC(**k), "auroc2": pkg.AUROC(average="weighted", **k),
        }),
        "flagship": lambda: pkg.MetricCollection({
            "acc": pkg.Accuracy(num_classes=10, **k), "stats": pkg.StatScores(reduce="macro", num_classes=10, **k),
        }),
        "curves_phase": lambda: pkg.MetricCollection({
            "auroc": pkg.AUROC(num_classes=5, average="macro", **k),
            "ap": pkg.AveragePrecision(num_classes=5, average="macro", **k),
            "ce": pkg.CalibrationError(n_bins=15, **k),
        }),
        "accuracies": lambda: pkg.MetricCollection({
            "a1": pkg.Accuracy(num_classes=5, **k), "a2": pkg.Accuracy(num_classes=5, **k),
            "a3": pkg.Accuracy(num_classes=5, top_k=2, **k), "ham": pkg.HammingDistance(**k),
            "ham2": pkg.HammingDistance(threshold=0.5, **k),
        }),
    }


@pytest.mark.parametrize("name", ["report", "curve_family", "flagship", "curves_phase", "accuracies"])
def test_compute_group_keys_match_the_reference(name):
    want = _collections(ref, False)[name]().compute_group_keys
    got = _collections(port, True)[name]().compute_group_keys
    assert got == want
    assert name not in ("report", "curve_family") or got


def test_stat_score_family_groups():
    mc = _stat_collection()
    mc.update(PREDS[0], TARGET[0])
    assert mc.compute_group_keys == [["f1", "prec", "rec", "spec"]]
    for name in ("tp", "fp", "tn", "fn"):
        assert getattr(mc["prec"], name) is getattr(mc["rec"], name) is getattr(mc["f1"], name)
        assert getattr(mc["prec"], name) is getattr(mc["spec"], name)


def test_one_update_dispatch_per_group(monkeypatch):
    calls = {"n": 0}
    orig = stat_scores_mod._stat_scores_update

    def counting(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(stat_scores_mod, "_stat_scores_update", counting)
    mc = _stat_collection()
    mc.update(PREDS[0], TARGET[0])
    assert calls["n"] == 1
    mc(PREDS[1], TARGET[1])
    assert calls["n"] == 2
    calls["n"] = 0
    ungrouped = _stat_collection(compute_groups=False)
    ungrouped.update(PREDS[0], TARGET[0])
    assert calls["n"] == 4


def test_accuracy_never_groups_with_stat_scores():
    mc = port.MetricCollection({
        "acc": port.Accuracy(num_classes=5, average="macro", mdmc_average=None, **CPU),
        "prec": port.Precision(num_classes=5, average="macro", **CPU),
        "rec": port.Recall(num_classes=5, average="macro", **CPU),
    })
    mc.update(PREDS[0], TARGET[0])
    assert mc.compute_group_keys == [["prec", "rec"]]
    assert mc["acc"]._compute_group is None


def test_accuracy_groups_with_equal_accuracy_and_shares_its_mode():
    def build(grouped):
        return port.MetricCollection({"a1": port.Accuracy(num_classes=5, **CPU), "a2": port.Accuracy(num_classes=5, **CPU)},
                                     compute_groups=grouped)

    mc, ungrouped = build(True), build(False)
    mc.update(PREDS[0], TARGET[0])
    ungrouped.update(PREDS[0], TARGET[0])
    assert mc.compute_group_keys == [["a1", "a2"]]
    assert mc["a2"].mode is not None and mc["a2"].mode == mc["a1"].mode
    _assert_tree_equal(mc.compute(), ungrouped.compute())


def test_differing_args_do_not_group():
    mc = port.MetricCollection({
        "p_macro": port.Precision(num_classes=5, average="macro", **CPU),
        "p_micro": port.Precision(average="micro", **CPU),
        "r_macro": port.Recall(num_classes=5, average="macro", **CPU),
    })
    mc.update(PREDS[0], TARGET[0])
    assert mc.compute_group_keys == [["p_macro", "r_macro"]]


def test_curve_family_shares_one_accumulation():
    mc, ungrouped = _curve_collection(), _curve_collection(compute_groups=False)
    for p, t in zip(BPREDS, BTARGET):
        mc.update(p, t)
        ungrouped.update(p, t)
    assert mc.compute_group_keys == [["ap", "prc", "roc"]]
    assert mc["roc"].preds is mc["prc"].preds and mc["roc"].target is mc["ap"].target
    _assert_tree_equal(mc.compute(), ungrouped.compute())


def test_curve_family_with_capacity_shares_one_catbuffer_and_survives_reset():
    mc = _curve_collection(capacity=256)
    for p, t in zip(BPREDS, BTARGET):
        mc.update(p, t)
    assert mc.compute_group_keys == [["ap", "prc", "roc"]]
    assert isinstance(mc["roc"].preds, CatBuffer)
    assert mc["roc"].preds is mc["prc"].preds is mc["ap"].preds
    assert len(mc["roc"].preds) == sum(len(p) for p in BPREDS)
    mc.reset()
    mc.update(BPREDS[1], BTARGET[1])
    assert mc.compute_group_keys == [["ap", "prc", "roc"]]
    assert mc["roc"].preds is mc["prc"].preds and len(mc["roc"].preds) == len(BPREDS[1])


def test_auroc_groups_within_its_class_only():
    mc = port.MetricCollection({"auroc": port.AUROC(**CPU), "auroc2": port.AUROC(**CPU), "roc": port.ROC(pos_label=1, **CPU)})
    mc.update(BPREDS[0], BTARGET[0])
    assert mc.compute_group_keys == [["auroc", "auroc2"]]
    assert mc["auroc2"].mode == mc["auroc"].mode


def test_mixed_capacity_does_not_group():
    mc = port.MetricCollection({"roc": port.ROC(pos_label=1, **CPU).with_capacity(128),
                                "prc": port.PrecisionRecallCurve(pos_label=1, **CPU)})
    mc.update(BPREDS[0], BTARGET[0])
    assert mc.compute_group_keys == []


def test_env_escape_hatch(monkeypatch):
    monkeypatch.setenv(COMPUTE_GROUPS_ENV, "0")
    assert not compute_groups_enabled()
    mc = _stat_collection()
    mc.update(PREDS[0], TARGET[0])
    assert mc.compute_group_keys == []
    assert mc["prec"].tp is not mc["rec"].tp


def test_explicit_override_groups_and_validates():
    mc = _stat_collection(compute_groups=[["prec", "rec"]])
    mc.update(PREDS[0], TARGET[0])
    assert mc.compute_group_keys == [["prec", "rec"]]
    assert mc["f1"]._compute_group is None
    with pytest.raises(MetricsTPUUserError, match="unknown metric"):
        _stat_collection(compute_groups=[["prec", "nope"]]).update(PREDS[0], TARGET[0])
    with pytest.raises(MetricsTPUUserError, match="more than one group"):
        _stat_collection(compute_groups=[["prec", "rec"], ["prec", "f1"]]).update(PREDS[0], TARGET[0])
    with pytest.raises(MetricsTPUUserError, match="different state schema"):
        port.MetricCollection({"prec": port.Precision(num_classes=5, average="macro", **CPU), "auroc": port.AUROC(**CPU)},
                              compute_groups=[["prec", "auroc"]]).update(PREDS[0], TARGET[0])
    prec = port.Precision(num_classes=5, average="macro", **CPU)
    prec.sync_strict_update_count = True
    with pytest.raises(MetricsTPUUserError, match="configured differently"):
        port.MetricCollection({"prec": prec, "rec": port.Recall(num_classes=5, average="macro", **CPU)},
                              compute_groups=[["prec", "rec"]]).update(PREDS[0], TARGET[0])
    p = port.Precision(num_classes=5, average="macro", **CPU)
    with pytest.raises(MetricsTPUUserError, match="several collection keys"):
        port.MetricCollection({"a": p, "b": p}, compute_groups=[["a", "b"]]).update(PREDS[0], TARGET[0])
    with pytest.raises(MetricsTPUUserError, match="compute_groups"):
        _stat_collection(compute_groups="yes")


def test_pre_diverged_member_stays_solo():
    prec = port.Precision(num_classes=5, average="macro", **CPU)
    prec.update(PREDS[1], TARGET[1])
    mc = port.MetricCollection({"prec": prec, "rec": port.Recall(num_classes=5, average="macro", **CPU)})
    mc.update(PREDS[0], TARGET[0])
    assert mc.compute_group_keys == []
    solo = port.Precision(num_classes=5, average="macro", **CPU)
    solo.update(PREDS[1], TARGET[1])
    solo.update(PREDS[0], TARGET[0])
    assert torch.equal(mc.compute()["prec"], solo.compute())


# ---------------------------------------------------------------------------
# grouped equals ungrouped, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["stat", "curve", "curve_capacity", "accuracy"])
@pytest.mark.parametrize("call", ["update", "forward"])
def test_grouped_bit_identical_to_ungrouped(family, call):
    def build(grouped):
        if family == "stat":
            return _stat_collection(compute_groups=grouped)
        if family == "curve":
            return _curve_collection(compute_groups=grouped)
        if family == "curve_capacity":
            return port.MetricCollection({"roc": port.ROC(pos_label=1, **CPU).with_capacity(256),
                                          "ap": port.AveragePrecision(pos_label=1, **CPU).with_capacity(256)},
                                         compute_groups=grouped)
        return port.MetricCollection({"a1": port.Accuracy(num_classes=5, **CPU),
                                      "a2": port.Accuracy(num_classes=5, top_k=2, **CPU),
                                      "a3": port.Accuracy(num_classes=5, **CPU)}, compute_groups=grouped)

    data = list(zip(PREDS, TARGET)) if family in ("stat", "accuracy") else list(zip(BPREDS, BTARGET))

    def feed(mc):
        outs = []
        for p, t in data:
            outs.append(mc(p, t) if call == "forward" else mc.update(p, t))
        return outs

    grouped, ungrouped = build(True), build(False)
    for _ in range(2):  # a second epoch after reset keeps the equivalence
        outs_g, outs_u = feed(grouped), feed(ungrouped)
        assert grouped.compute_group_keys
        if call == "forward":
            for og, ou in zip(outs_g, outs_u):
                _assert_tree_equal(og, ou)
        _assert_tree_equal(grouped.compute(), ungrouped.compute())
        grouped.reset()
        ungrouped.reset()


# ---------------------------------------------------------------------------
# copy-on-write detach
# ---------------------------------------------------------------------------

def test_direct_update_detaches_without_corrupting_siblings():
    mc = _stat_collection()
    mc.update(PREDS[0], TARGET[0])
    before = mc.compute()
    mc["prec"].update(PREDS[1], TARGET[1])
    assert mc["prec"]._compute_group is None
    assert mc.compute_group_keys == [["f1", "rec", "spec"]]
    after = mc.compute()
    for key in ("rec", "f1", "spec"):
        assert torch.equal(before[key], after[key])
    solo = port.Precision(num_classes=5, average="macro", **CPU)
    solo.update(PREDS[0], TARGET[0])
    solo.update(PREDS[1], TARGET[1])
    assert torch.equal(after["prec"], solo.compute())


def test_direct_update_detaches_curve_member_without_shared_append():
    mc = _curve_collection()
    mc.update(BPREDS[0], BTARGET[0])
    mc["ap"].update(BPREDS[1], BTARGET[1])
    assert mc["ap"]._compute_group is None
    assert len(mc["roc"].preds) == 1 and len(mc["ap"].preds) == 2


def test_stray_forward_merges_in_place_into_its_own_copy():
    """A detached member's ``forward`` appends into its accumulation's
    CatBuffer in place: the detach cloned it, so the former siblings keep
    their rows."""
    mc = _curve_collection(capacity=256)
    mc(BPREDS[0], BTARGET[0])
    shared = mc["roc"].preds
    rows = shared.values().clone()
    mc["ap"](BPREDS[1], BTARGET[1])
    assert mc["ap"]._compute_group is None and mc["ap"].preds is not shared
    assert mc["roc"].preds is shared is mc["prc"].preds
    assert len(shared) == len(BPREDS[0]) and torch.equal(shared.values(), rows)
    assert len(mc["ap"].preds) == len(BPREDS[0]) + len(BPREDS[1])
    assert torch.equal(mc["ap"].preds.values(), torch.cat([BPREDS[0], BPREDS[1]]))


def test_direct_state_assignment_detaches():
    mc = _stat_collection()
    mc.update(PREDS[0], TARGET[0])
    mc["rec"].tp = torch.zeros_like(mc["rec"].tp)
    assert mc["rec"]._compute_group is None
    assert int(mc["prec"].tp.sum()) > 0
    mc.update(PREDS[1], TARGET[1])
    solo = port.Recall(num_classes=5, average="macro", **CPU)
    solo.update(PREDS[1], TARGET[1])
    assert torch.equal(mc["rec"].tp, solo.tp)


def test_direct_reset_detaches_and_collection_reset_regroups():
    mc = _stat_collection()
    mc.update(PREDS[0], TARGET[0])
    mc["rec"].reset()
    assert mc["rec"]._compute_group is None
    assert int(mc["rec"].tp.sum()) == 0 and int(mc["prec"].tp.sum()) > 0
    mc.reset()
    mc.update(PREDS[0], TARGET[0])
    assert mc.compute_group_keys == [["f1", "prec", "rec", "spec"]]


def test_member_cast_detaches_but_collection_cast_keeps_groups():
    mc = port.MetricCollection({"a": port.CalibrationError(**CPU), "b": port.CalibrationError(**CPU)})
    assert mc.compute_group_keys == []  # CalibrationError declares no identity
    mc = _curve_collection(capacity=64)
    mc.update(BPREDS[0], BTARGET[0])
    mc.double()
    assert mc.compute_group_keys == [["ap", "prc", "roc"]]
    assert mc["roc"].preds is mc["ap"].preds and mc["roc"].preds.buffer.dtype == torch.float64
    mc["roc"].float()
    assert mc["roc"]._compute_group is None and mc["ap"].preds.buffer.dtype == torch.float64


def test_failed_group_dispatch_breaks_group_without_clobbering_siblings():
    def build(grouped):
        return port.MetricCollection({"p": port.Precision(num_classes=5, average="macro", **CPU),
                                      "r": port.Recall(num_classes=5, average="macro", **CPU)}, compute_groups=grouped)

    grouped, ungrouped = build(True), build(False)
    for mc in (grouped, ungrouped):
        mc(PREDS[0], TARGET[0])
        with pytest.raises(Exception):
            mc(PREDS[0], TARGET[0][:-5])
    assert grouped["p"]._compute_group is None
    assert torch.equal(grouped["r"].tp, ungrouped["r"].tp)
    grouped.update(PREDS[1], TARGET[1])
    ungrouped.update(PREDS[1], TARGET[1])
    assert torch.equal(grouped["r"].tp, ungrouped["r"].tp)
    grouped.reset()
    grouped.update(PREDS[0], TARGET[0])
    assert grouped.compute_group_keys == [["p", "r"]]


# ---------------------------------------------------------------------------
# clone and state_dict round trips
# ---------------------------------------------------------------------------

def test_clone_with_prefix_keeps_groups_and_detaches_from_original():
    mc = _stat_collection()
    mc.update(PREDS[0], TARGET[0])
    val = mc.clone(prefix="val_")
    assert val.compute_group_keys == [["f1", "prec", "rec", "spec"]]
    assert val["prec"].tp is val["rec"].tp and val["prec"].tp is not mc["prec"].tp
    assert sorted(val.compute()) == ["val_f1", "val_prec", "val_rec", "val_spec"]
    val.update(PREDS[1], TARGET[1])
    assert mc["prec"]._update_count == 1 and val["prec"]._update_count == 2


def test_state_dict_round_trip_grouped_to_ungrouped_and_back():
    grouped = _stat_collection()
    grouped.persistent(True)
    for p, t in zip(PREDS, TARGET):
        grouped.update(p, t)
    sd = grouped.state_dict()
    assert {f"{k}.{s}" for k in grouped.keys() for s in ("tp", "fp", "tn", "fn")} <= set(sd)
    ungrouped = _stat_collection(compute_groups=False)
    ungrouped.persistent(True)
    ungrouped.load_state_dict(sd)
    _assert_tree_equal(grouped.compute(), ungrouped.compute())
    back = _stat_collection()
    back.persistent(True)
    back.load_state_dict(ungrouped.state_dict())
    _assert_tree_equal(grouped.compute(), back.compute())
    back.update(PREDS[0], TARGET[0])
    assert back.compute_group_keys == [["f1", "prec", "rec", "spec"]]
    ungrouped.update(PREDS[0], TARGET[0])
    _assert_tree_equal(back.compute(), ungrouped.compute())


def test_load_state_dict_with_divergent_states_does_not_group():
    donor_a = port.Precision(num_classes=5, average="macro", **CPU)
    donor_b = port.Recall(num_classes=5, average="macro", **CPU)
    donor_a.update(PREDS[0], TARGET[0])
    donor_b.update(PREDS[1], TARGET[1])
    sd = {f"prec.{k}": v for k, v in donor_a._state.items()}
    sd.update({f"rec.{k}": v for k, v in donor_b._state.items()})
    mc = port.MetricCollection({"prec": port.Precision(num_classes=5, average="macro", **CPU),
                                "rec": port.Recall(num_classes=5, average="macro", **CPU)})
    mc.update(PREDS[2], TARGET[2])
    assert mc.compute_group_keys == [["prec", "rec"]]
    mc.load_state_dict(sd)
    mc.update(PREDS[2], TARGET[2])
    assert mc.compute_group_keys == []
    donor_a.update(PREDS[2], TARGET[2])
    assert torch.equal(mc["prec"].tp, donor_a.tp)


# ---------------------------------------------------------------------------
# grouped sync, two ranks on threads
# ---------------------------------------------------------------------------

RPREDS = [torch.from_numpy(rng.rand(32, 5).astype(np.float32)) for _ in range(WORLD)]
RTARGET = [torch.from_numpy(rng.randint(0, 5, (32,))) for _ in range(WORLD)]


@pytest.fixture
def world(monkeypatch):
    clear_sync_plan_cache()
    return TorchLockstepWorld(WORLD).install(monkeypatch)


def _snapshot(mc):
    out = {}
    for key, m in mc.items():
        for name, v in m._state.items():
            out[f"{key}.{name}"] = v.values().clone() if isinstance(v, CatBuffer) else v
    return out


def _run_collection_sync(world, build, feed):
    world.calls = world.bytes = 0

    def body(rank):
        mc = build()
        feed(mc, rank)
        mc.sync()
        synced = _snapshot(mc)
        values = mc.compute()  # members compute from the synced state
        mc.unsync()
        return synced, values, _snapshot(mc)

    return world.run(body), world.bytes


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_member"])
def test_grouped_stat_sync_bit_identical_and_smaller(world, monkeypatch, fused):
    if not fused:
        monkeypatch.setenv("METRICS_TPU_FUSED_SYNC", "0")

    def feed(mc, rank):
        mc.update(RPREDS[rank], RTARGET[rank])

    g_out, g_bytes = _run_collection_sync(world, _stat_collection, feed)
    u_out, u_bytes = _run_collection_sync(world, lambda: _stat_collection(compute_groups=False), feed)
    for rank in range(WORLD):
        for part in range(3):
            _assert_tree_equal(g_out[rank][part], u_out[rank][part])
    if fused:
        assert g_bytes < u_bytes  # one tp/fp/tn/fn quartet instead of four
    else:
        assert g_bytes == u_bytes  # the per-member loop never dedupes
    # the synced counts are the world's sums
    assert torch.equal(g_out[0][0]["prec.tp"], g_out[0][2]["prec.tp"] + g_out[1][2]["prec.tp"])


def test_grouped_curve_sync_bit_identical_and_smaller(world):
    def feed(mc, rank):
        mc.update(BPREDS[rank][: 16 + 8 * rank], BTARGET[rank][: 16 + 8 * rank])

    g_out, g_bytes = _run_collection_sync(world, lambda: _curve_collection(capacity=64), feed)
    u_out, u_bytes = _run_collection_sync(world, lambda: _curve_collection(capacity=64, compute_groups=False), feed)
    for rank in range(WORLD):
        _assert_tree_equal(g_out[rank][0], u_out[rank][0])
        _assert_tree_equal(g_out[rank][1], u_out[rank][1])
        _assert_tree_equal(g_out[rank][2], u_out[rank][2])
    assert g_bytes < u_bytes


def test_grouped_sync_keeps_views_shared_after_unsync(world):
    def body(rank):
        mc = _stat_collection()
        mc.update(RPREDS[rank], RTARGET[rank])
        with mc.sync_context():
            assert mc["prec"].tp is mc["rec"].tp
            synced_tp = mc["prec"].tp.clone()
        assert mc["prec"].tp is mc["rec"].tp
        return synced_tp, mc["prec"].tp.clone()

    results = world.run(body)
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][0], results[0][1] + results[1][1])


def test_divergent_rank_raises_same_typed_error_on_all_ranks(world):
    def body(rank):
        n = 5 if rank == 0 else 7
        mc = port.MetricCollection({"prec": port.Precision(num_classes=n, average="macro", **CPU),
                                    "rec": port.Recall(num_classes=n, average="macro", **CPU)})
        mc.update(torch.rand(8, n), torch.randint(0, n, (8,)))
        mc.sync()

    assert world.run_catching(body) == [StateDivergenceError] * WORLD


def test_poisoned_rank_raises_nonfinite_on_all_ranks(world):
    def body(rank):
        mc = port.MetricCollection({"roc": port.ROC(pos_label=1, **CPU).enable_check_finite(),
                                    "prc": port.PrecisionRecallCurve(pos_label=1, **CPU).enable_check_finite()})
        preds = BPREDS[0].clone()
        if rank == 1:
            preds[3] = float("nan")
        mc.update(preds, BTARGET[0])
        assert mc.compute_group_keys == [["prc", "roc"]]
        mc.sync()

    assert world.run_catching(body) == [NonFiniteStateError] * WORLD


def test_on_error_local_degrades_grouped_collection_without_breaking_views(world):
    def body(rank):
        n = 5 if rank == 0 else 7
        mc = port.MetricCollection({"prec": port.Precision(num_classes=n, average="macro", **CPU),
                                    "rec": port.Recall(num_classes=n, average="macro", **CPU)})
        p, t = torch.rand(8, n), torch.randint(0, n, (8,))
        mc.update(p, t)
        local_tp = mc["prec"].tp.clone()
        mc.sync(on_error="warn")
        assert all(not m._is_synced and m._sync_degraded for m in mc.values())
        assert torch.equal(mc["prec"].tp, local_tp) and mc["prec"].tp is mc["rec"].tp
        mc.unsync()
        mc.update(p, t)
        assert mc["prec"].tp is mc["rec"].tp and torch.equal(mc["prec"].tp, 2 * local_tp)
        return mc["prec"]._update_count

    assert world.run(body) == [2, 2]


def test_fused_sync_payload_dedupes_to_unique_states(world, monkeypatch):
    captured = {}
    orig = sync_mod.host_sync_state

    def spying(state, reductions, *args, **kwargs):
        captured.setdefault("n_keys", len(state))
        return orig(state, reductions, *args, **kwargs)

    monkeypatch.setattr(sync_mod, "host_sync_state", spying)

    def body(rank):
        mc = _stat_collection()
        mc.update(RPREDS[rank], RTARGET[rank])
        mc.sync()
        mc.unsync()

    world.calls = 0
    world.run(body)
    assert captured["n_keys"] == 4  # 4 members x 4 states, one quartet
    assert world.calls == 2  # the header and one int64 sum bucket


def test_compute_syncs_once_and_not_again_from_the_cache(world):
    def body(rank):
        mc = _stat_collection()
        mc.update(RPREDS[rank], RTARGET[rank])
        first = mc.compute()
        calls_after_first = world.calls
        again = mc.compute()
        assert all(not m._is_synced for m in mc.values())  # the local states are back
        return first, again, calls_after_first

    world.calls = 0
    (first, again, calls), _ = world.run(body)
    assert calls == world.calls == 2  # one header, one int64 sum bucket; none the second time
    _assert_tree_equal(first, again)
