"""The plain reference against confusion matrices and values worked out by
hand."""
import math
import os

import pytest
import torch

from tiny import ROOT

import importlib.util

_spec = importlib.util.spec_from_file_location("ref_confusion", os.path.join(ROOT, "portbench", "reference",
                                                                             "confusion.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

# 3 classes, 8 samples; rows are true classes, columns predicted ones
TARGET = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2])
LABELS = torch.tensor([0, 0, 1, 1, 2, 2, 2, 0])
CM = [[2, 1, 0],
      [0, 1, 1],
      [1, 0, 2]]


def _probs(labels, classes=3):
    p = torch.full((len(labels), classes), 0.1)
    p[torch.arange(len(labels)), labels] = 0.8
    return p


def _spec(cls, **args):
    return {"class": cls, "args": args}


@pytest.mark.parametrize("form", ["labels", "probs"])
def test_pass_confmat_by_hand(form):
    preds = LABELS if form == "labels" else _probs(LABELS)
    cm = ref.pass_confmat([(preds, TARGET)], 3)
    assert cm.dtype == torch.int64 and cm.tolist() == CM


def test_pass_confmat_weights_a_repeated_block():
    preds, target = _probs(LABELS), TARGET
    other = (_probs(torch.tensor([2, 2])), torch.tensor([2, 1]))
    cm = ref.pass_confmat([(preds, target), other, (preds, target)], 3)
    want = [[2 * v for v in row] for row in CM]
    want[2][2] += 1
    want[1][2] += 1
    assert cm.tolist() == want


def test_pass_confmat_of_images():
    # [N, C, H, W] scores against [N, H, W] targets
    t = torch.tensor([[[0, 1], [2, 2]]])
    p = torch.zeros(1, 3, 2, 2)
    p[0, 0, 0, 0] = p[0, 2, 0, 1] = p[0, 2, 1, 0] = p[0, 1, 1, 1] = 1.0
    assert ref.pass_confmat([(p, t)], 3).tolist() == [[1, 0, 0], [0, 0, 1], [0, 1, 1]]


def test_stat_states_by_hand():
    cm = torch.tensor(CM)
    s = ref.member_state(_spec("Precision", num_classes=3, average="macro"), cm)
    assert s["tp"].tolist() == [2, 1, 2]
    assert s["fp"].tolist() == [1, 1, 1]
    assert s["fn"].tolist() == [1, 1, 1]
    assert s["tn"].tolist() == [4, 5, 4]
    h = ref.member_state(_spec("HammingDistance"), cm)
    # 3 of 8 wrong: each differs from its one-hot target in two of 3 labels
    assert int(h["correct"]) == 24 - 6 and int(h["total"]) == 24


def test_values_by_hand():
    cm = torch.tensor(CM)
    prec = [2 / 3, 1 / 2, 2 / 3]
    rec = [2 / 3, 1 / 2, 2 / 3]
    f1 = [2 * p * r / (p + r) for p, r in zip(prec, rec)]
    spec = [4 / 5, 5 / 6, 4 / 5]
    want = {
        "Precision": sum(prec) / 3, "Recall": sum(rec) / 3, "F1": sum(f1) / 3, "Specificity": sum(spec) / 3,
        "HammingDistance": 6 / 24, "IoU": (2 / 4 + 1 / 3 + 2 / 4) / 3,
    }
    for cls, v in want.items():
        args = {"num_classes": 3, "average": "macro"} if cls in ("Precision", "Recall", "F1", "Specificity") else (
            {"num_classes": 3} if cls == "IoU" else {})
        assert float(ref.member_value(_spec(cls, **args), cm)) == pytest.approx(v, abs=1e-12), cls
    # MCC: c = 5 correct of s = 8; true counts t = [3, 2, 3], predicted p = [3, 2, 3]
    c, s, t, p = 5, 8, [3, 2, 3], [3, 2, 3]
    mcc = (c * s - sum(a * b for a, b in zip(t, p))) / (
        math.sqrt(s * s - sum(b * b for b in p)) * math.sqrt(s * s - sum(a * a for a in t)))
    assert float(ref.member_value(_spec("MatthewsCorrcoef", num_classes=3), cm)) == pytest.approx(mcc, abs=1e-12)
    # kappa: observed agreement 5/8, expected sum(t * p) / s^2 = 22/64
    po, pe = 5 / 8, 22 / 64
    assert float(ref.member_value(_spec("CohenKappa", num_classes=3), cm)) == pytest.approx(
        (po - pe) / (1 - pe), abs=1e-12)
    norm = ref.member_value(_spec("ConfusionMatrix", num_classes=3, normalize="true"), cm)
    assert norm.flatten().tolist() == pytest.approx([2 / 3, 1 / 3, 0, 0, 1 / 2, 1 / 2, 1 / 3, 0, 2 / 3])


def test_absent_classes_follow_the_metrics_definitions():
    # class 2 never appears: left out of the macro precision, recall and F1,
    # kept (as 1) in the macro specificity, scored 0 by IoU
    cm = torch.tensor([[2, 1, 0], [1, 2, 0], [0, 0, 0]])
    macro = {"num_classes": 3, "average": "macro"}
    assert float(ref.member_value(_spec("Precision", **macro), cm)) == pytest.approx(2 / 3)
    assert float(ref.member_value(_spec("Specificity", **macro), cm)) == pytest.approx((2 / 3 + 2 / 3 + 1) / 3)
    assert float(ref.member_value(_spec("IoU", num_classes=3), cm)) == pytest.approx((2 / 4 + 2 / 4 + 0) / 3)
    norm = ref.member_value(_spec("ConfusionMatrix", num_classes=3, normalize="true"), cm)
    assert norm[2].tolist() == [0, 0, 0]


def test_unsupported_arguments_raise():
    with pytest.raises(NotImplementedError):
        ref.member_value(_spec("Precision", num_classes=3, average="micro"), torch.tensor(CM))
    with pytest.raises(NotImplementedError):
        ref.member_state(_spec("AUROC", num_classes=3), torch.tensor(CM))


def test_reference_matches_the_port_on_a_random_pass():
    """The reference and the port agree on one random pass at a small size:
    they were written apart, from the same definitions."""
    import metrics_tpu_torch as mtt

    g = torch.Generator().manual_seed(5)
    probs = torch.rand(64, 7, generator=g).softmax(-1)
    target = torch.randint(0, 7, (64,), generator=g)
    cm = ref.pass_confmat([(probs, target)], 7)
    for cls, args in [("Precision", {"average": "macro"}), ("Recall", {"average": "macro"}),
                      ("F1", {"average": "macro"}), ("Specificity", {"average": "macro"}),
                      ("ConfusionMatrix", {"normalize": "true"}), ("MatthewsCorrcoef", {}), ("CohenKappa", {}),
                      ("IoU", {})]:
        m = getattr(mtt, cls)(num_classes=7, device="cpu", **args)
        m.update(probs, target)
        want = ref.member_value(_spec(cls, num_classes=7, **args), cm)
        assert torch.allclose(m.compute().double(), want, atol=1e-6), cls
