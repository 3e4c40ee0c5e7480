"""Specificity, the true-negative rate, from the stat scores.

Counterpart of ``metrics_tpu/functional/classification/specificity.py``.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.precision_recall import _prf_stat_scores
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _specificity_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> torch.Tensor:
    numerator = tn
    denominator = tn + fp
    if average in (AverageMethod.NONE, None) and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        absent = (tp | fn | fp) == 0
        numerator = numerator.masked_fill(absent, -1)
        denominator = denominator.masked_fill(absent, -1)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else denominator,
        average=average,
        mdmc_average=mdmc_average,
    )


def specificity(
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
    r"""Specificity :math:`\frac{TN}{TN + FP}` in one stateless call; the
    arguments are those of :func:`~metrics_tpu_torch.functional.precision`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import specificity
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> round(float(specificity(preds, target, average="micro")), 4)
        0.75
    """
    tp, fp, tn, fn = _prf_stat_scores(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)
