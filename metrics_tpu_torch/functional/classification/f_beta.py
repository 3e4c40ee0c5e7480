"""F-beta and F1 from the stat scores.

Counterpart of ``metrics_tpu/functional/classification/f_beta.py``: the same
float32 cast points, and ``-1`` sentinels instead of filtering out absent or
ignored classes.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.precision_recall import _prf_stat_scores
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _safe_divide(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """``num / denom`` with zero denominators replaced by 1."""
    return num / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def _fbeta_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: Optional[str],
    mdmc_average: Optional[str],
) -> torch.Tensor:
    """F-beta from the stat scores."""
    if average == AverageMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        # negative (ignored) entries stay out of the global sums
        valid = tp >= 0
        tp_s = torch.sum(torch.where(valid, tp, 0)).to(torch.float32)
        fp_s = torch.sum(torch.where(valid, fp, 0)).to(torch.float32)
        fn_s = torch.sum(torch.where(valid, fn, 0)).to(torch.float32)
        precision = _safe_divide(tp_s, tp_s + fp_s)
        recall = _safe_divide(tp_s, tp_s + fn_s)
    else:
        precision = _safe_divide(tp.to(torch.float32), (tp + fp).to(torch.float32))
        recall = _safe_divide(tp.to(torch.float32), (tp + fn).to(torch.float32))

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)

    # classes absent from preds and target (nan for "none", left out of
    # "macro"), merged with the user's ignore_index
    if average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
        mask = torch.zeros(tp.shape, dtype=torch.bool, device=tp.device)
        if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
            mask = mask | ((tp | fn | fp) == 0)
        if ignore_index is not None:
            if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
                mask = mask | (torch.arange(tp.shape[-1], device=tp.device) == ignore_index)
            else:
                onehot = torch.arange(tp.shape[0], device=tp.device) == ignore_index
                mask = mask | onehot.reshape((-1,) + (1,) * (tp.ndim - 1))
        num = num.masked_fill(mask, -1.0)
        denom = denom.masked_fill(mask, -1.0)

    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        # == -3 catches the classes _stat_scores_update flags with -1 when
        # ignore_index is set with reduce="macro"
        total = tp + fp + fn
        cond = (total == 0) | (total == -3)
        num = num.masked_fill(cond, -1.0)
        denom = denom.masked_fill(cond, -1.0)

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta(
    preds: torch.Tensor,
    target: torch.Tensor,
    beta: float = 1.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> torch.Tensor:
    r"""F-beta :math:`(1+\beta^2)\frac{P \cdot R}{\beta^2 P + R}` in one
    stateless call; ``beta < 1`` leans toward precision, ``beta > 1`` toward
    recall. The other arguments are those of
    :func:`~metrics_tpu_torch.functional.precision`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import fbeta
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> round(float(fbeta(preds, target, num_classes=3, beta=0.5)), 4)
        0.3333
    """
    tp, fp, tn, fn = _prf_stat_scores(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1(
    preds: torch.Tensor,
    target: torch.Tensor,
    beta: float = 1.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> torch.Tensor:
    """F1, the harmonic mean of precision and recall: :func:`fbeta` with
    ``beta = 1`` whatever ``beta`` says, as in the JAX package.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import f1
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> round(float(f1(preds, target, num_classes=3)), 4)
        0.3333
    """
    return fbeta(preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
