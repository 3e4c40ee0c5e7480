"""The multiclass confusion-matrix count (metrics_tpu_torch/ops/confusion_counts.py)
against the plain composition it replaces on CUDA
(``functional/classification/confusion_matrix.py::_confusion_matrix_update_plain``).

On the CPU: the kernel's function in torch (``_confusion_counts_plain``, fed
by the update's own validation and width rule) equals the composition bit for
bit on every case below, the wrapper's plan is a function of the shapes, its
argument checks raise, and a CUDA batch under ``FakeTensorMode`` reaches the
op. On the card the kernel equals the composition, and a compiled collection
equals its eager twin. The JAX package is compared in ``test_torch_confmat.py``;
this file imports none of it, so that its card cases run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_confusion_counts.py
"""
import importlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import metrics_tpu_torch as port
from metrics_tpu_torch.core.compiled import program_mode
from metrics_tpu_torch.ops import confusion_counts as cc

# the module, which the package's function of the same name hides
cm = importlib.import_module("metrics_tpu_torch.functional.classification.confusion_matrix")

H100_SMS = 132


def _scores(shape, seed, plant=None, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(dtype)
    if plant == "ties":
        # few levels, so that most rows hold a tied maximum; one row all equal
        x = np.round(x * 3) / 3
        x[0] = 0.5
    elif plant == "nonfinite":
        u = rng.rand(*shape)
        x[u < 0.05] = np.nan
        x[(u >= 0.05) & (u < 0.1)] = np.inf
        x[(u >= 0.1) & (u < 0.15)] = -np.inf
        x[0] = np.nan
        x[min(1, shape[0] - 1)] = -np.inf
    return torch.from_numpy(x)


def _labels(shape, seed, lo, hi, dtype=torch.int64):
    return torch.from_numpy(np.random.RandomState(seed).randint(lo, hi, shape)).to(dtype)


# name -> (preds, target, num_classes, program): `program` runs the update as
# a compiled program does, with the value checks off, so that labels outside
# the classes reach the count
CASES = {
    "scores-C2": lambda: (_scores((64, 2), 1), _labels((64,), 2, 0, 2), 2, False),
    "scores-C3": lambda: (_scores((64, 3), 3), _labels((64,), 4, 0, 3), 3, False),
    "scores-C19": lambda: (_scores((64, 19), 5), _labels((64,), 6, 0, 19), 19, False),
    "scores-C1000": lambda: (_scores((8, 1000), 7), _labels((8,), 8, 0, 1000), 1000, False),
    "scores-C1001": lambda: (_scores((8, 1001), 9), _labels((8,), 10, 0, 1001), 1001, False),
    "scores-X1": lambda: (_scores((16, 19, 1), 11), _labels((16, 1), 12, 0, 19), 19, False),
    "scores-X7": lambda: (_scores((6, 19, 7), 13), _labels((6, 7), 14, 0, 19), 19, False),
    "scores-X7x4": lambda: (_scores((3, 5, 7, 4), 15), _labels((3, 7, 4), 16, 0, 5), 5, False),
    "ties-rows": lambda: (_scores((64, 19), 17, "ties"), _labels((64,), 18, 0, 19), 19, False),
    "ties-planes": lambda: (_scores((4, 19, 32), 19, "ties"), _labels((4, 32), 20, 0, 19), 19, False),
    "ties-C1000": lambda: (_scores((8, 1000), 21, "ties"), _labels((8,), 22, 0, 1000), 1000, False),
    "nonfinite-rows": lambda: (_scores((64, 19), 23, "nonfinite"), _labels((64,), 24, 0, 19), 19, False),
    "nonfinite-planes": lambda: (_scores((4, 19, 32), 25, "nonfinite"), _labels((4, 32), 26, 0, 19), 19, False),
    "nonfinite-C1000": lambda: (_scores((8, 1000), 27, "nonfinite"), _labels((8,), 28, 0, 1000), 1000, False),
    "scores-float64": lambda: (_scores((32, 19), 29, "ties", np.float64), _labels((32,), 30, 0, 19), 19, False),
    "scores-float16": lambda: (_scores((32, 19), 31).half(), _labels((32,), 32, 0, 19), 19, False),
    "scores-int32-target": lambda: (_scores((32, 19), 33), _labels((32,), 34, 0, 19, torch.int32), 19, False),
    "scores-bool-target": lambda: (_scores((32, 2), 35), _labels((32,), 36, 0, 2).bool(), 2, False),
    "labels": lambda: (_labels((4, 32), 37, 0, 19), _labels((4, 32), 38, 0, 19), 19, False),
    "labels-int32": lambda: (_labels((4, 32), 39, 0, 19, torch.int32), _labels((4, 32), 40, 0, 19, torch.int32), 19,
                             False),
    # preds labels past num_classes pass the value checks
    "labels-preds-past-C": lambda: (_labels((64,), 60, 0, 25), _labels((64,), 61, 0, 19), 19, False),
    "labels-uint8": lambda: (_labels((64,), 41, 0, 19, torch.uint8), _labels((64,), 42, 0, 19), 19, False),
    # outside [0, W): negative, equal to C, past max(2, C)
    "labels-out-of-range": lambda: (_labels((4, 32), 43, -3, 23), _labels((4, 32), 44, -3, 23), 19, True),
    "labels-out-of-range-int32": lambda: (_labels((4, 32), 45, -3, 23, torch.int32),
                                          _labels((4, 32), 46, -3, 23, torch.int32), 19, True),
    "labels-equal-C": lambda: (torch.full((40,), 19), _labels((40,), 47, 17, 20), 19, True),
    "labels-past-width": lambda: (_labels((40,), 48, 0, 4), _labels((40,), 49, 0, 4), 1, True),
    "scores-target-out-of-range": lambda: (_scores((64, 19), 50), _labels((64,), 51, -3, 23), 19, True),
    # num_classes that the validation rejects: the classes are inferred
    "infer-scores-wider": lambda: (_scores((64, 5), 52), _labels((64,), 53, 0, 5), 3, False),
    "infer-scores-narrower": lambda: (_scores((64, 4), 54), _labels((64,), 55, 0, 4), 6, False),
    "infer-labels": lambda: (_labels((64,), 56, 0, 8), _labels((64,), 57, 0, 8), 5, False),
    "infer-C1-labels": lambda: (_labels((64,), 58, 0, 3), _labels((64,), 59, 0, 3), 1, False),
}
# an empty batch: the value checks raise, and in a compiled program each path
# fails to shape it or counts nothing, alike
EMPTY = {
    "empty-scores": lambda: (torch.zeros((0, 19)), torch.zeros((0,), dtype=torch.int64), 19),
    "empty-labels": lambda: (torch.zeros((0, 5), dtype=torch.int64), torch.zeros((0, 5), dtype=torch.int64), 5),
    "empty-positions": lambda: (torch.zeros((2, 19, 0)), torch.zeros((2, 0), dtype=torch.int64), 19),
}


def _update(fn, preds, target, num_classes, program):
    if program:
        with program_mode():
            return fn(preds, target, num_classes)
    return fn(preds, target, num_classes)


def _counts_plain(preds, target, num_classes, program):
    """The kernel's function in torch, fed as the CUDA update feeds the kernel."""

    def run(p, t, nc):
        operands = cm._kernel_operands(*cm._validated_case(p, t, nc, 0.5), nc)
        assert operands is not None
        p, t, width = operands
        return cc._confusion_counts_plain(p, t, nc, width)

    return _update(run, preds, target, num_classes, program)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_function_equals_the_composition(case):
    preds, target, num_classes, program = CASES[case]()
    want = _update(cm._confusion_matrix_update_plain, preds, target, num_classes, program)
    got = _counts_plain(preds, target, num_classes, program)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    # a CPU batch takes the composition itself
    assert torch.equal(_update(cm._confusion_matrix_update, preds, target, num_classes, program), want)


@pytest.mark.parametrize(
    "preds,target",
    [
        (torch.rand(8), torch.randint(0, 2, (8,))),  # binary
        (torch.rand(8, 3), torch.randint(0, 2, (8, 3))),  # multi-label
        (torch.rand(8, 1), torch.randint(0, 2, (8,))),  # C = 1 squeezes to binary
        (torch.rand(8, 3), torch.rand(8)),  # float target
    ],
)
def test_other_cases_take_the_composition(preds, target):
    with program_mode():
        assert cm._kernel_operands(*cm._validated_case(preds, target, 3, 0.5), 3) is None


def _outcome(fn, *args):
    try:
        return fn(*args)
    except (ValueError, RuntimeError) as err:
        return type(err)


@pytest.mark.parametrize("case", sorted(EMPTY))
@pytest.mark.parametrize("program", [False, True])
def test_an_empty_batch_takes_the_composition(case, program):
    preds, target, num_classes = EMPTY[case]()
    want = _outcome(_update, cm._confusion_matrix_update_plain, preds, target, num_classes, program)
    got = _outcome(_update, cm._confusion_matrix_update, preds, target, num_classes, program)
    assert want is ValueError if not program else True
    assert got is want if isinstance(want, type) else torch.equal(got, want)
    with program_mode():
        case = _outcome(cm._validated_case, preds, target, num_classes, 0.5)
        assert case is ValueError or cm._kernel_operands(*case, num_classes) is None


@pytest.mark.parametrize(
    "preds,target,match",
    [
        (torch.rand(8, 3), torch.randint(0, 3, (7,)), "same first dimension"),  # a value check
        (torch.rand(8, 3), torch.randint(0, 3, (8, 2)), "same shape"),  # malformed shapes
    ],
)
def test_a_check_raises_as_in_the_composition(preds, target, match):
    for fn in (cm._confusion_matrix_update_plain, cm._confusion_matrix_update, cm._validated_case):
        with pytest.raises(ValueError, match=match):
            fn(preds, target, 3, 0.5)


def test_a_cuda_batch_reaches_the_op_under_fake_tensors(monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("the plain composition ran")

    monkeypatch.setattr(cm, "_confusion_matrix_composed", plain)
    with FakeTensorMode():
        for preds, target in (
            (torch.empty((2, 19, 8, 16), device="cuda"), torch.empty((2, 8, 16), dtype=torch.int64, device="cuda")),
            (torch.empty((2, 8, 16), dtype=torch.int64, device="cuda"),
             torch.empty((2, 8, 16), dtype=torch.int32, device="cuda")),
            (torch.empty((6, 1000), device="cuda"), torch.empty((6,), dtype=torch.int64, device="cuda")),
        ):
            out = cm._confusion_matrix_update(preds, target, 19)
            assert out.shape == (19, 19) and out.dtype == torch.int64 and out.is_cuda


@pytest.mark.parametrize(
    "labels,n,c,x,nc,want",
    [
        # the main path's three shapes
        (False, 1, 19, 1024 * 2048, 19, ("planes", 1, 4 * H100_SMS, True)),
        (True, 1, 1, 1024 * 2048, 19, ("labels", 1, 4 * H100_SMS, True)),
        (False, 2000, 1000, 1, 1000, ("rows", 32, 250, False)),
        # [N, C] rows: a thread per row up to 32 classes, then groups of lanes
        (False, 64, 32, 1, 32, ("planes", 1, 1, True)),
        (False, 64, 33, 1, 33, ("rows", 2, 1, True)),
        (False, 64, 100, 1, 100, ("rows", 4, 1, True)),
        (False, 64, 1001, 1, 1001, ("rows", 32, 8, False)),
        (False, 6, 19, 7, 19, ("planes", 1, 1, True)),
    ],
)
def test_plan_is_a_function_of_the_shapes(labels, n, c, x, nc, want):
    assert cc._plan(labels, n, c, x, nc, H100_SMS) == want


def test_plan_cuts_shared_memory_at_the_squared_classes():
    # 4 * nc**2 bytes of bins against a block's 232,448 less 1,024
    assert cc._plan(True, 1, 1, 1 << 20, 240, H100_SMS)[3] is True
    assert cc._plan(True, 1, 1, 1 << 20, 241, H100_SMS)[3] is False
    # bins that fill most of an SM leave room for one block there
    assert cc._plan(True, 1, 1, 1 << 20, 240, H100_SMS)[2] == H100_SMS
    assert cc._plan(True, 1, 1, 1 << 20, 150, H100_SMS)[2] == 2 * H100_SMS
    assert cc._plan(True, 1, 1, 1 << 20, 100, H100_SMS)[2] == 4 * H100_SMS


def test_plan_keeps_a_blocks_count_below_its_bins_range():
    n = 3 << 40  # positions
    _, _, blocks, _ = cc._plan(True, n, 1, 1, 19, 1)
    assert n / blocks <= cc._BLOCK_POSITIONS


@pytest.mark.parametrize(
    "preds,target,nc,width,match",
    [
        (torch.rand(4, 3, dtype=torch.float16), torch.zeros(4, dtype=torch.int64), 3, 3, "must be float32"),
        (torch.rand(4, 3), torch.zeros(4, dtype=torch.int16), 3, 3, "must be float32"),
        (torch.rand(4, 3), torch.zeros(5, dtype=torch.int64), 3, 3, "expected scores"),
        (torch.rand(4), torch.zeros(4, dtype=torch.int64), 3, 3, "expected scores"),
        (torch.zeros(4, 2, dtype=torch.int64), torch.zeros(4, dtype=torch.int64), 3, 3, "expected scores"),
        (torch.rand(4, 3), torch.zeros(4, dtype=torch.int64), 0, 3, "out of the kernel's range"),
        (torch.rand(4, 3), torch.zeros(4, dtype=torch.int64), 3, 2**31, "out of the kernel's range"),
        (torch.rand(4, 0), torch.zeros(4, dtype=torch.int64), 3, 3, "out of the kernel's range"),
        (torch.rand(4, 3), torch.zeros(4, dtype=torch.int64), 3, 3, "must be a CUDA tensor"),
    ],
)
def test_kernel_wrapper_checks_its_arguments(preds, target, nc, width, match):
    with pytest.raises(ValueError, match=match):
        cc._confusion_counts_kernel(preds, target, nc, width)


def test_the_launch_is_counted_through_replays():
    from metrics_tpu_torch.core.compiled import _launch_counters

    assert (cc, "KERNEL_LAUNCHES") in _launch_counters()


# ---- on the card ----------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _seg(seed, dtype=np.float32):
    # the segmentation shape of the main path, [1, 19, 1024, 2048]
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.rand(1, 19, 1024, 2048).astype(dtype)), _labels((1, 1024, 2048), seed + 1, 0, 19)


CARD_CASES = dict(CASES)
CARD_CASES["seg-scores"] = lambda: (*_seg(60), 19, False)
CARD_CASES["seg-labels"] = lambda: (_labels((1, 1024, 2048), 62, 0, 19), _labels((1, 1024, 2048), 63, 0, 19), 19,
                                    False)
CARD_CASES["report-rows"] = lambda: (_scores((2000, 1000), 64), _labels((2000,), 65, 0, 1000), 1000, False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_equals_the_composition_on_the_card(case):
    device = _card()
    preds, target, num_classes, program = CARD_CASES[case]()
    want = _update(cm._confusion_matrix_update_plain, preds, target, num_classes, program)
    p, t = preds.to(device), target.to(device)
    launches = cc.KERNEL_LAUNCHES
    got = _update(cm._confusion_matrix_update, p, t, num_classes, program)
    plain = _update(cm._confusion_matrix_update_plain, p, t, num_classes, program)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), want) and torch.equal(plain.cpu(), want)
    # every case is (multi-dim) multi-class: one launch, none for an empty batch
    assert cc.KERNEL_LAUNCHES - launches == int(target.numel() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EMPTY))
@pytest.mark.parametrize("program", [False, True])
def test_an_empty_batch_on_the_card(case, program):
    device = _card()
    preds, target, num_classes = EMPTY[case]()
    want = _outcome(_update, cm._confusion_matrix_update_plain, preds, target, num_classes, program)
    p, t = preds.to(device), target.to(device)
    launches = cc.KERNEL_LAUNCHES
    got = _outcome(_update, cm._confusion_matrix_update, p, t, num_classes, program)
    assert got is want if isinstance(want, type) else torch.equal(got.cpu(), want)
    # the wrapper counts nothing, with no launch
    zeros = torch.zeros((num_classes, num_classes), dtype=torch.int64)
    assert torch.equal(cc._confusion_counts_kernel(p, t, num_classes, max(2, num_classes)).cpu(), zeros)
    assert cc.KERNEL_LAUNCHES == launches


def _offset(x, k):
    """``x``'s values in a contiguous tensor that starts ``k`` elements into
    its storage: no 16-byte loads there."""
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    out = buf[k:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize(
    "preds,target,nc,width",
    [
        (_scores((64, 1), 70), _labels((64,), 71, -1, 3), 1, 2),  # C = 1
        (_scores((64, 1), 72), _labels((64,), 73, 0, 2), 2, 2),
        (_scores((512, 300), 74, "ties"), _labels((512,), 75, 0, 300), 300, 300),  # rows, global bins
        (_scores((96, 38), 76, "nonfinite"), _labels((96,), 77, 0, 38), 38, 38),  # rows, C % 4 != 0
        (_scores((3, 7, 4096), 78, "nonfinite"), _labels((3, 4096), 79, 0, 7, torch.int32), 7, 7),
        (_scores((2, 241, 64), 80), _labels((2, 64), 81, 0, 241), 241, 241),  # planes, global bins
        (_labels((100003,), 82, -2, 500), _labels((100003,), 83, -2, 500, torch.int32), 500, 497),
        (_labels((4096,), 84, 0, 19, torch.int32), _labels((4096,), 85, 0, 19), 5, 19),  # cells past nc*nc
        (_scores((5, 6, 8), 86, "ties", np.float64), _labels((5, 8), 87, 0, 6), 6, 6),
    ],
)
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_equals_its_plain_form_on_the_card(preds, target, nc, width, offset):
    device = _card()
    want = cc._confusion_counts_plain(preds, target, nc, width)
    p, t = _offset(preds.to(device), offset), _offset(target.to(device), offset)
    got = cc._confusion_counts_kernel(p, t, nc, width)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _seg_collection(device, compiled):
    mc = port.MetricCollection({"confmat": port.ConfusionMatrix(19, device=device),
                                "iou": port.IoU(19, device=device)})
    for m in mc.values():
        m.compiled_update = None if compiled else False
    return mc


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["scores", "labels"])
def test_compiled_collection_equals_its_eager_twin(form):
    device = _card()
    g = torch.Generator(device=device).manual_seed(90)
    scores = torch.rand((24, 2, 19, 64, 128), generator=g, device=device)
    target = torch.randint(0, 19, (24, 2, 64, 128), generator=g, device=device)
    preds = scores if form == "scores" else scores.argmax(2)
    eager, compiled = _seg_collection(device, False), _seg_collection(device, True)
    for i in range(16):  # the eager steps before the compiled path takes over
        eager.update(preds[i], target[i])
        compiled.update(preds[i], target[i])
    eager_launches, compiled_launches = [], []
    for i in range(16, 24):
        before = cc.KERNEL_LAUNCHES
        eager.update(preds[i], target[i])
        mid = cc.KERNEL_LAUNCHES
        compiled.update(preds[i], target[i])
        eager_launches.append(mid - before)
        compiled_launches.append(cc.KERNEL_LAUNCHES - mid)
    torch.cuda.synchronize()
    cs = compiled.compile_stats()
    dispatches = cs["collection"]["dispatches"] + sum(s["dispatches"] for s in cs["members"].values())
    traces = cs["collection"]["traces"] + sum(s["traces"] for s in cs["members"].values())
    assert dispatches >= 8 and traces >= 1 and cs["collection"]["fallback"] is None
    # a launch per member update in an eager step and in each replay, and the
    # launches of each program's eager run once
    assert eager_launches[0] >= 1 and set(eager_launches) == {eager_launches[0]}
    assert compiled_launches[-4:] == eager_launches[-4:]
    assert sum(compiled_launches) == sum(eager_launches) + traces * eager_launches[0]
    for k, m in eager.items():
        for name, v in m._state.items():
            assert torch.equal(v, compiled[k]._state[name]), (k, name)
    ve, vc = eager.compute(), compiled.compute()
    assert all(torch.equal(ve[k], vc[k]) for k in ve)
