"""Precision and recall from the stat scores.

Counterpart of ``metrics_tpu/functional/classification/precision_recall.py``.
Classes absent from preds and target are flagged with ``-1`` denominators
(static shapes, no host read) rather than filtered out.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _mask_absent_classes(
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flag classes absent from preds and target with -1: ``"macro"`` leaves
    them out of the mean, ``"none"`` reports them as nan."""
    if mdmc_average != MDMCAverageMethod.SAMPLEWISE and average in (
        AverageMethod.MACRO,
        AverageMethod.NONE,
        None,
    ):
        absent = (tp + fp + fn) == 0
        numerator = numerator.masked_fill(absent, -1)
        denominator = denominator.masked_fill(absent, -1)
    return numerator, denominator


def _precision_compute(
    tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor, average: Optional[str], mdmc_average: Optional[str]
) -> torch.Tensor:
    numerator, denominator = _mask_absent_classes(tp, tp + fp, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != "weighted" else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _recall_compute(
    tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor, average: Optional[str], mdmc_average: Optional[str]
) -> torch.Tensor:
    numerator, denominator = _mask_absent_classes(tp, tp + fn, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != "weighted" else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _check_prf_args(
    average: Optional[str],
    mdmc_average: Optional[str],
    num_classes: Optional[int],
    ignore_index: Optional[int],
) -> None:
    allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    allowed_mdmc_average = [None, "samplewise", "global"]
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if average in ["macro", "weighted", "none", None] and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _prf_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    ignore_index: Optional[int],
    num_classes: Optional[int],
    threshold: float,
    top_k: Optional[int],
    multiclass: Optional[bool],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the arguments, then count tp/fp/tn/fn with the reduction the
    ``average`` needs (per class for weighted/none)."""
    _check_prf_args(average, mdmc_average, num_classes, ignore_index)
    return _stat_scores_update(
        preds, target, reduce="macro" if average in ["weighted", "none", None] else average,
        mdmc_reduce=mdmc_average, threshold=threshold, num_classes=num_classes, top_k=top_k,
        multiclass=multiclass, ignore_index=ignore_index,
    )


def precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> torch.Tensor:
    r"""Precision :math:`\frac{TP}{TP + FP}` in one stateless call.

    Args:
        preds: labels, probabilities or logits in any supported shape.
        target: ground-truth labels of the matching shape.
        average: ``"micro"`` pools every decision, ``"macro"`` averages the
            per-class scores, ``"weighted"`` weights them by support,
            ``"samples"`` scores per sample, ``"none"``/``None`` returns the
            ``[C]`` vector (nan for absent classes).
        mdmc_average: multidim policy (``"global"``/``"samplewise"``/``None``).
        ignore_index: class label excluded from every count.
        num_classes: class count; required for per-class averages.
        threshold: binarization cut for probabilistic input.
        top_k: count top-k multiclass hits instead of the argmax only.
        multiclass: force/forbid multiclass interpretation.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> round(float(precision(preds, target, average="macro", num_classes=3)), 4)
        0.2222
    """
    tp, fp, _, fn = _prf_stat_scores(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> torch.Tensor:
    r"""Recall :math:`\frac{TP}{TP + FN}` in one stateless call; arguments as
    for :func:`precision`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import recall
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> round(float(recall(preds, target, average="macro", num_classes=3)), 4)
        0.3333
    """
    tp, fp, _, fn = _prf_stat_scores(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return _recall_compute(tp, fp, fn, average, mdmc_average)


def precision_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(precision, recall)`` from one stat-score pass over the inputs;
    arguments as for :func:`precision`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision_recall
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> p, r = precision_recall(preds, target, average="macro", num_classes=3)
        >>> round(float(p), 4), round(float(r), 4)
        (0.2222, 0.3333)
    """
    tp, fp, _, fn = _prf_stat_scores(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return _precision_compute(tp, fp, fn, average, mdmc_average), _recall_compute(tp, fp, fn, average, mdmc_average)
