"""Plain reference for the confusion-matrix members: the confusion matrix of
a pass by ``bincount``, and every member's state and value from it.

Plain PyTorch, written from the metrics' definitions (torchmetrics 0.5
semantics, which the measured package follows); it imports nothing of the
package under test. Values are computed in ``dtype``: float64 for the
reference, a lower precision for the control (where the preds are scores,
the control also rounds them to that precision before taking the argmax).
"""
from typing import Dict, Iterable

import torch

_STAT_SCORES = ("Precision", "Recall", "F1", "Specificity")


def pass_confmat(steps: Iterable, classes: int, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """int64 ``[C, C]`` counts (rows true, columns predicted) of one pass of
    ``(preds, target)`` steps; a block the pass repeats is counted once and
    weighted by its repeats."""
    repeats: Dict[int, list] = {}
    for p, t in steps:
        repeats.setdefault(p.data_ptr(), [p, t, 0])[2] += 1
    cm = None
    for p, t, n in repeats.values():
        labels = p
        if p.is_floating_point():
            labels = (p.to(dtype) if dtype.itemsize < p.element_size() else p).argmax(1)
        counts = torch.bincount((t.reshape(-1) * classes + labels.reshape(-1)), minlength=classes * classes)
        cm = counts * n if cm is None else cm + counts * n
    return cm.reshape(classes, classes)


def _macro_args(spec: dict) -> None:
    args = spec.get("args", {})
    unsupported = {k: v for k, v in args.items() if k not in ("num_classes", "average")}
    if args.get("average") != "macro" or unsupported:
        raise NotImplementedError(f"reference: {spec['class']} with {args}")


def member_state(spec: dict, cm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The state a member holds after folding the samples ``cm`` counts."""
    cls = spec["class"]
    if cls in _STAT_SCORES:
        _macro_args(spec)
        tp = cm.diagonal()
        fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
        return {"tp": tp, "fp": fp, "tn": cm.sum() - tp - fp - fn, "fn": fn}
    if cls in ("ConfusionMatrix", "CohenKappa", "MatthewsCorrcoef", "IoU"):
        return {"confmat": cm}
    if cls == "HammingDistance":
        # each sample is a one-hot row of C labels: a wrong argmax differs in two
        n, c = cm.sum(), cm.shape[0]
        return {"correct": n * c - 2 * (n - cm.trace()), "total": n * c}
    raise NotImplementedError(f"reference: no state for {cls}")


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b, and 0 where b is 0."""
    return torch.where(b == 0, torch.zeros_like(a), a / torch.where(b == 0, torch.ones_like(b), b))


def member_value(spec: dict, cm: torch.Tensor, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The member's value from the pass's confusion matrix, in ``dtype``."""
    cls, args = spec["class"], spec.get("args", {})
    m = cm.to(dtype)
    tp, rows, cols, n = m.diagonal(), m.sum(1), m.sum(0), m.sum()
    fp, fn = cols - tp, rows - tp
    present = (cm.sum(0) + cm.sum(1)) > 0  # tp + fp + fn > 0
    if cls in _STAT_SCORES:
        _macro_args(spec)
        if cls == "Specificity":  # macro keeps every class
            tn = n - tp - fp - fn
            return _div(tn, tn + fp).mean()
        prec, rec = _div(tp, tp + fp), _div(tp, tp + fn)
        score = {"Precision": prec, "Recall": rec, "F1": _div(2 * prec * rec, prec + rec)}[cls]
        return score[present].mean()
    if cls == "ConfusionMatrix":
        if args.get("normalize") not in (None, "none", "true") or set(args) - {"num_classes", "normalize"}:
            raise NotImplementedError(f"reference: ConfusionMatrix with {args}")
        return _div(m, rows[:, None].expand_as(m)) if args.get("normalize") == "true" else m
    if cls == "MatthewsCorrcoef":
        return (tp.sum() * n - (rows * cols).sum()) / (
            torch.sqrt(n * n - (cols * cols).sum()) * torch.sqrt(n * n - (rows * rows).sum()))
    if cls == "CohenKappa":
        if args.get("weights") is not None:
            raise NotImplementedError(f"reference: CohenKappa with {args}")
        expected = torch.outer(rows, cols) / n
        off = 1 - torch.eye(m.shape[0], dtype=dtype, device=m.device)
        return 1 - (off * m).sum() / (off * expected).sum()
    if cls == "IoU":
        if set(args) - {"num_classes"}:
            raise NotImplementedError(f"reference: IoU with {args}")
        return _div(tp, rows + cols - tp).mean()
    if cls == "HammingDistance":
        state = member_state(spec, cm)
        return 1 - state["correct"].to(dtype) / state["total"].to(dtype)
    raise NotImplementedError(f"reference: no value for {cls}")
