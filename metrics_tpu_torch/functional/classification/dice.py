"""Dice score per class, reduced over classes.

Counterpart of ``metrics_tpu/functional/classification/dice.py``: one
vectorized pass over all classes, with the no-foreground and 0/0 cases masked.
"""
import torch

from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utils.data import to_categorical


def dice_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Dice = 2·TP / (2·TP + FP + FN) per class, in float32.

    Args:
        preds: ``[N, C, ...]`` scores (argmaxed over dim 1) or labels.
        target: ``[N, ...]`` labels.
        bg: include class 0 (the background).
        nan_score: the score of a class with an empty denominator.
        no_fg_score: the score of a class absent from the target.
        reduction: ``"elementwise_mean"``, ``"sum"`` or ``"none"``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import dice_score
        >>> pred = torch.tensor([[0.85, 0.05, 0.05, 0.05], [0.05, 0.85, 0.05, 0.05]])
        >>> target = torch.tensor([0, 1])
        >>> round(float(dice_score(pred, target)), 4)
        0.3333
    """
    num_classes = preds.shape[1]
    start = 0 if bg else 1

    if preds.ndim == target.ndim + 1:
        preds = to_categorical(preds, argmax_dim=1)

    classes = torch.arange(num_classes, device=preds.device)
    pred_is = preds.reshape(-1)[None, :] == classes[:, None]  # [C, N]
    targ_is = target.reshape(-1)[None, :] == classes[:, None]
    tp = torch.sum(pred_is & targ_is, dim=1).to(torch.float32)
    fp = torch.sum(pred_is & ~targ_is, dim=1).to(torch.float32)
    fn = torch.sum(~pred_is & targ_is, dim=1).to(torch.float32)
    support = torch.sum(targ_is, dim=1)

    denom = 2 * tp + fp + fn
    score = 2 * tp / torch.where(denom == 0, torch.ones_like(denom), denom)
    score = torch.where(denom == 0, torch.full_like(score, nan_score), score)
    score = torch.where(support == 0, torch.full_like(score, no_fg_score), score)
    return reduce(score[start:], reduction=reduction)
