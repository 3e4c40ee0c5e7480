"""tp/fp/tn/fn statistics — the backbone of the classification family.

Counterpart of ``metrics_tpu/functional/classification/stat_scores.py``.
Counts are int64 (the JAX package's are int32, because x64 is off there).
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _del_column(data: torch.Tensor, idx: int) -> torch.Tensor:
    """Drop class column ``idx``."""
    return torch.cat([data[:, :idx], data[:, idx + 1:]], dim=1)


def _stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: Optional[str] = "micro",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count tp/fp/tn/fn over binary ``(N, C)`` or ``(N, C, X)`` inputs.

    Output shapes per ``reduce``: micro → scalar / (N,), macro → (C,) / (N,C),
    samples → (N,) / (N,X).
    """
    if reduce == "micro":
        dim: Tuple[int, ...] = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = (0,) if preds.ndim == 2 else (2,)
    else:  # samples
        dim = (1,)

    true_pred = target == preds
    pos_pred = preds == 1

    tp = torch.sum(true_pred & pos_pred, dim=dim)
    fp = torch.sum(~true_pred & pos_pred, dim=dim)
    tn = torch.sum(true_pred & ~pos_pred, dim=dim)
    fn = torch.sum(~true_pred & ~pos_pred, dim=dim)
    return tp, fp, tn, fn


def _stat_scores_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    validate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Format inputs and count statistics."""
    preds, target, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes,
        multiclass=multiclass, top_k=top_k, validate=validate,
    )

    if ignore_index is not None and not 0 <= ignore_index < preds.shape[1]:
        raise ValueError(
            f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes"
        )
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            preds = torch.transpose(preds, 1, 2).reshape(-1, preds.shape[1])
            target = torch.transpose(target, 1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro":
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce)

    if ignore_index is not None and reduce == "macro":
        for t in (tp, fp, tn, fn):
            t[..., ignore_index] = -1

    return tp, fp, tn, fn


def _stat_scores_compute(tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> torch.Tensor:
    """Stack tp/fp/tn/fn/support into one ``(..., 5)`` output."""
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, torch.full_like(outputs, -1), outputs)


def _reduce_stat_scores(
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    weights: Optional[torch.Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> torch.Tensor:
    """Turn numerator/denominator statistics into a final averaged score.

    Handles zero-division, ignored classes (denominator < 0 → masked out),
    and the micro/macro/weighted/samples/none axes, branch-free, in float32
    as the JAX package does.
    """
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)
    numerator = torch.where(zero_div_mask, torch.full_like(numerator, float(zero_division)), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, torch.ones_like(denominator), denominator)
    weights = torch.where(ignore_mask, torch.zeros_like(weights), weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    scores = torch.where(torch.isnan(scores), torch.full_like(scores, float(zero_division)), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        if scores.ndim == 0:
            # torch.mean(dim=0) accepts a 0-d tensor; the JAX package's
            # jnp.mean(axis=0) raises IndexError on it, and so does the port
            raise IndexError(
                "`mdmc_average='samplewise'` averages the scores of each sample of multi-dim multi-class "
                "input, but these inputs reduced to one scalar score: the input is not multi-dim multi-class."
            )
        scores = torch.mean(scores, dim=0)
        ignore_mask = torch.sum(ignore_mask, dim=0).bool()

    if average in (AverageMethod.NONE, None):
        return torch.where(ignore_mask, torch.full_like(scores, float("nan")), scores)
    return torch.sum(scores)


def stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Count tp/fp/tn/fn/support with flexible reduction.

    Args:
        preds: predictions — labels, probabilities, or logits in any
            supported classification shape.
        target: ground-truth labels of the matching shape.
        reduce: ``"micro"`` one global quartet, ``"macro"`` a ``[C]`` quartet
            per class, ``"samples"`` one per sample.
        mdmc_reduce: multidim policy (``"global"``/``"samplewise"``/``None``).
        num_classes: class count; required for ``"macro"``.
        top_k: one-hot the k best multiclass scores instead of the argmax.
        threshold: binarization cut for probabilistic input.
        multiclass: force/forbid multiclass interpretation.
        ignore_index: class label whose rows/columns drop from every count.

    Returns:
        ``[..., 5]`` stacked ``[tp, fp, tn, fn, support]``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.classification.stat_scores import stat_scores
        >>> stat_scores(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]), reduce="micro").tolist()
        [3, 1, 3, 1, 4]
    """
    if reduce not in ["micro", "macro", "samples"]:
        raise ValueError(f"The `reduce` {reduce} is not valid.")
    if mdmc_reduce not in [None, "samplewise", "global"]:
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    tp, fp, tn, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_reduce, top_k=top_k,
        threshold=threshold, num_classes=num_classes, multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)
