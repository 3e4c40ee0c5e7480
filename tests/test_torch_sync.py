"""Cross-process sync of the port on two real gloo ranks (CPU).

One spawn of two processes serves every test in this file: each rank drives
its own, uneven share of the batches, then reports what its synced
``compute()`` returned. The synced values must equal one process that saw all
the batches. Ranks whose metrics disagree on their state schema raise the
same ``StateDivergenceError`` on both ranks, from the health header. The
in-program sync (``pure_sync``/``compiled_step`` on ``torch.distributed``'s
functional collectives) runs over a ``new_group`` subgroup, the default
group, a rank list and a ``DeviceMesh``, and an overlapped round over real
gloo resolves as the blocking sync does.
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import metrics_tpu_torch as port
import metrics_tpu_torch.parallel.sync as sync_mod
from metrics_tpu_torch.parallel.sync import gather_all_arrays, host_sync_leaf
from metrics_tpu_torch.utils.exceptions import StateDivergenceError, SyncError

C = 10
# uneven batch sizes and batch counts per rank
RANK_BATCHES = {0: [100, 37], 1: [64, 90, 11]}
CAPACITY = 256


def _batches(rank):
    rng = np.random.RandomState(10 + rank)
    return [
        (torch.from_numpy(rng.rand(n, C).astype(np.float32)), torch.from_numpy(rng.randint(0, C, n)))
        for n in RANK_BATCHES[rank]
    ]


def _flagship():
    return port.MetricCollection({
        "acc": port.Accuracy(num_classes=C, device="cpu"),
        "stats": port.StatScores(reduce="macro", num_classes=C, device="cpu"),
        "samples": port.StatScores(reduce="samples", num_classes=C, device="cpu"),
    })


def _report():
    k = dict(num_classes=C, device="cpu")
    return port.MetricCollection({
        "prec": port.Precision(average="macro", **k),
        "rec": port.Recall(average="macro", **k),
        "f1": port.F1(average="macro", **k),
        "spec": port.Specificity(average="macro", **k),
        "confmat": port.ConfusionMatrix(C, device="cpu"),
        "mcc": port.MatthewsCorrcoef(C, device="cpu"),
        "hamming": port.HammingDistance(device="cpu"),
    })


TEXT_PREDS = ["the cat sat on the mat. it was happy!", "hello there general kenobi", "a b c d",
              "one two three. four five!", "same words here"]
TEXT_REFS = ["a cat sat on a mat. it was glad.", "hello there master kenobi", "a c d b",
             "one two. three four five?", "same words here"]
TEXT_SHARES = {0: (0, 2), 1: (2, 5)}
TEXT_EMB = np.random.RandomState(7).randn(30522, 8).astype(np.float32)


def _embed(input_ids, attention_mask):
    return torch.from_numpy(TEXT_EMB)[input_ids.long()]


def _text_metrics():
    return (port.BERTScore(model=_embed, max_length=16, idf=True, device="cpu"),
            port.ROUGEScore(use_stemmer=True, device="cpu"))


def _worker(rank, world, port_no, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port_no}", world_size=world, rank=rank)
    try:
        result = {}
        mc = _flagship()
        for p, t in _batches(rank):
            mc(p, t)
        local = {k: m._state for k, m in mc.items()}
        result["synced"] = mc.compute()
        # compute() restores the local state after syncing
        result["restored"] = all(
            all(torch.equal(torch.as_tensor(v[0] if isinstance(v, list) else v),
                            torch.as_tensor(m._state[n][0] if isinstance(v, list) else m._state[n]))
                for n, v in local[k].items())
            for k, m in mc.items()
        )
        shapes = [tuple(x.shape) for x in gather_all_arrays(torch.zeros(rank + 2, 3))]
        result["gathered_shapes"] = shapes

        # a list state left empty on one rank: every rank raises together
        samples = port.StatScores(reduce="samples", num_classes=C, device="cpu")
        if rank == 0:
            samples.update(*_batches(0)[0])
        try:
            samples.compute()
            result["empty_list"] = "no error"
        except StateDivergenceError as err:
            result["empty_list"] = type(err).__name__

        # fixed-capacity states: uneven rows per rank, gathered in rank order
        auroc = port.AUROC(num_classes=C, device="cpu").with_capacity(CAPACITY)
        for p, t in _batches(rank):
            auroc.update(p, t)
        result["auroc_synced"] = auroc.compute()
        result["auroc_rows_after"] = (len(auroc.preds), auroc.preds.capacity)
        merged = host_sync_leaf(auroc.preds, "cat")
        result["auroc_gathered"] = (merged.capacity, merged.values())

        # a CatBuffer state empty on one rank, then one overflowed on one
        # rank: every rank raises together
        for case in ("empty", "overflowed"):
            m = port.AUROC(device="cpu").with_capacity(16)
            if rank == 0 or case == "overflowed":
                m.update(torch.rand(4), torch.randint(0, 2, (4,)))
            if rank == 0 and case == "overflowed":
                m.preds.overflowed = True
            try:
                with m.sync_context():
                    pass
                result[case] = "no error"
            except SyncError as err:
                result[case] = type(err).__name__

        # the grouped report collection: compute() syncs it once, through
        # one header and one bucketed plan
        report = _report()
        for p, t in _batches(rank):
            report(p, t)
        result["report_groups"] = report.compute_group_keys
        calls = []
        raw = sync_mod._all_gather
        sync_mod._all_gather = lambda x, group: calls.append(x.numel()) or raw(x, group)
        try:
            result["report"] = report.compute()
        finally:
            sync_mod._all_gather = raw
        result["report_collectives"] = len(calls)

        # BERTScore's int32 token cat states and ROUGE's per-sentence cat
        # lists: each rank its own sentences, gathered in rank order
        bertscore, rouge = _text_metrics()
        share = slice(*TEXT_SHARES[rank])
        bertscore.update(TEXT_PREDS[share], TEXT_REFS[share])
        rouge.update(TEXT_PREDS[share], TEXT_REFS[share])
        result["bertscore"], result["rouge"] = bertscore.compute(), rouge.compute()
        result["bertscore_local_rows"] = len(torch.cat(bertscore.preds_input_ids))

        # schema-divergent ranks: num_classes 10 against 12, and a scalar
        # (micro) state against a [C] (macro) one
        for case, (reduce, c) in {"num_classes": ("macro", C + 2 * rank), "state_rank": (("micro", "macro")[rank], C)}.items():
            m = port.StatScores(reduce=reduce, num_classes=c, device="cpu")
            m.update(torch.rand(8, c), torch.randint(0, c, (8,)))
            try:
                m.compute()
                result[case] = "no error"
            except Exception as err:  # noqa: BLE001 - the class is the result
                result[case] = type(err).__name__

        # the in-program sync on gloo's functional collectives: the report
        # collection's pure state over a subgroup, the default group, a rank
        # list and a 1-D DeviceMesh; a whole step over the subgroup
        from torch.distributed.device_mesh import init_device_mesh

        sub = dist.new_group([0, 1])
        mesh = init_device_mesh("cpu", (world,))
        report = _report()
        state = report.init_state()
        for p, t in _batches(rank):
            state = report.pure_update(state, p, t)
        result["funcol"] = {
            name: report.pure_compute(report.pure_sync(state, axis_name=axis, fused=fused))
            for name, axis, fused in (("subgroup", sub, True), ("world", dist.group.WORLD, False),
                                      ("ranks", [0, 1], True), ("mesh", mesh, True), ("mesh_dim", (mesh, 0), True))
        }
        report = _report()
        st = report.init_state()
        for p, t in _batches(rank)[:2]:
            st, values = report.compiled_step(st, p, t, axis_name=sub)
        result["funcol_step"] = values

        # an overlapped round over real gloo resolves as the blocking sync does
        over, block = _flagship(), _flagship()
        for p, t in _batches(rank):
            over.update(p, t)
            block.update(p, t)
        over.sync(blocking=False)
        over.sync()
        block.sync()
        result["overlap_equal"] = all(
            torch.equal(torch.as_tensor(v), torch.as_tensor(block[k]._state[n]))
            for k, m in over.items() for n, v in m._state.items() if not isinstance(v, list))
        over.unsync()
        block.unsync()
        result["overlap_stats"] = over.sync_stats()["collection"]
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_rank_results(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("gloo"))
    mp.start_processes(_worker, args=(2, _free_port(), out_dir), nprocs=2, join=True, start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(2)]


def test_synced_compute_equals_one_process_on_all_batches(two_rank_results):
    single = _flagship()
    for rank in sorted(RANK_BATCHES):
        for p, t in _batches(rank):
            single.update(p, t)
    want = single.compute()
    for rank, result in enumerate(two_rank_results):
        got = result["synced"]
        assert sorted(got) == sorted(want)
        torch.testing.assert_close(got["acc"], want["acc"], rtol=0, atol=1e-6)
        assert torch.equal(got["stats"], want["stats"]), rank
        # list state: rank order, then batch order, as the gather concatenates
        assert torch.equal(got["samples"], want["samples"]), rank
        assert result["restored"], rank


def test_uneven_gather_trims_each_rank(two_rank_results):
    for result in two_rank_results:
        assert result["gathered_shapes"] == [(2, 3), (3, 3)]


def test_empty_list_state_raises_on_every_rank(two_rank_results):
    assert [r["empty_list"] for r in two_rank_results] == ["StateDivergenceError"] * 2


def test_with_capacity_auroc_syncs_uneven_rows(two_rank_results):
    """A ``with_capacity`` AUROC synced over ranks holding 137 and 165 rows
    equals one process that saw every batch, and ``compute()`` leaves each
    rank its own rows."""
    single = port.AUROC(num_classes=C, device="cpu").with_capacity(2 * CAPACITY)
    rows = []
    for rank in sorted(RANK_BATCHES):
        for p, t in _batches(rank):
            single.update(p, t)
            rows.append(p)
    want = single.compute()
    for rank, result in enumerate(two_rank_results):
        assert torch.equal(result["auroc_synced"], want), rank
        assert result["auroc_rows_after"] == (sum(RANK_BATCHES[rank]), CAPACITY)
        capacity, values = result["auroc_gathered"]
        assert capacity == 2 * CAPACITY
        assert torch.equal(values, torch.cat(rows))


def test_empty_or_overflowed_catbuffer_raises_on_every_rank(two_rank_results):
    assert [r["empty"] for r in two_rank_results] == ["StateDivergenceError"] * 2
    assert [r["overflowed"] for r in two_rank_results] == ["SyncError"] * 2


def test_grouped_report_collection_syncs_once_through_the_fused_path(two_rank_results):
    single = _report()
    for rank in sorted(RANK_BATCHES):
        for p, t in _batches(rank):
            single.update(p, t)
    want = single.compute()
    for rank, result in enumerate(two_rank_results):
        assert result["report_groups"] == [["f1", "prec", "rec", "spec"]]
        # one header, one int64 sum bucket, one float32 sum bucket (hamming)
        assert result["report_collectives"] == 3, rank
        got = result["report"]
        assert sorted(got) == sorted(want)
        assert torch.equal(got["confmat"], want["confmat"]), rank
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-6)


def test_schema_divergent_ranks_raise_state_divergence_on_every_rank(two_rank_results):
    for case in ("num_classes", "state_rank"):
        assert [r[case] for r in two_rank_results] == ["StateDivergenceError"] * 2, case


def test_bertscore_and_rouge_cat_states_sync_to_one_process(two_rank_results):
    """BERTScore's token states and ROUGE's cat lists gathered from two
    ranks (2 and 3 sentences) score as one process over all 5, on every
    rank: the same token rows in the same order, so equal values."""
    bertscore, rouge = _text_metrics()
    bertscore.update(TEXT_PREDS, TEXT_REFS)
    rouge.update(TEXT_PREDS, TEXT_REFS)
    want_bs, want_rouge = bertscore.compute(), rouge.compute()
    for rank, result in enumerate(two_rank_results):
        assert result["bertscore"] == want_bs, rank
        assert sorted(result["rouge"]) == sorted(want_rouge)
        for key, v in want_rouge.items():
            assert torch.equal(result["rouge"][key], v), (rank, key)
        assert result["bertscore_local_rows"] == TEXT_SHARES[rank][1] - TEXT_SHARES[rank][0]


def test_in_program_sync_on_gloo_funcol_over_groups(two_rank_results):
    """``pure_sync`` on gloo's functional collectives, over a ``new_group``
    subgroup, the default group, a rank list and a ``DeviceMesh``, fused or
    not, serves what the host sync serves; so does ``compiled_step`` with
    the subgroup as its axis (on the CPU its program runs the collectives
    directly)."""
    single = _report()
    for rank in sorted(RANK_BATCHES):
        for p, t in _batches(rank):
            single.update(p, t)
    want = single.compute()
    step = _report()
    for rank in sorted(RANK_BATCHES):
        for p, t in _batches(rank)[:2]:
            step.update(p, t)
    want_step = step.compute()
    for rank, result in enumerate(two_rank_results):
        for name, got in result["funcol"].items():
            assert torch.equal(got["confmat"], want["confmat"]), (rank, name)
            for key in want:
                torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-6)
        for key in want_step:
            torch.testing.assert_close(result["funcol_step"][key], want_step[key], rtol=0, atol=1e-6)


def test_overlapped_round_on_gloo_equals_blocking(two_rank_results):
    for result in two_rank_results:
        assert result["overlap_equal"]
        assert result["overlap_stats"]["launched"] == 1 and result["overlap_stats"]["resolved"] == 1
