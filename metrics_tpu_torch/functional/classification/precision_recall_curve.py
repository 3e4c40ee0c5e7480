"""Precision-recall curve — functional layer.

Counterpart of ``metrics_tpu/functional/classification/precision_recall_curve.py``.
A curve has one point per distinct score, so its length depends on the data:
each binary curve reads the data on the host twice, once for the distinct
scores (``nonzero`` in :func:`_binary_clf_curve`) and once for the first
point of full recall; a multi-class curve does so once per class. The
fixed-threshold alternative with no host read is the Binned* family.

The scores are sorted with ``torch.sort(-preds, stable=True)``: that is the
order of the JAX package's ``jnp.argsort(-preds)``, ties in input order and
NaN scores last (``torch.sort(preds, descending=True)`` would put NaN first).
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utils.prints import rank_zero_warn


def _binary_clf_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cumulative false and true positives at each distinct score, in
    descending score order, and those scores (sklearn's contract)."""
    if sample_weights is not None and not isinstance(sample_weights, torch.Tensor):
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)

    if preds.shape[0] == 0:
        # the JAX package's gather of the last row fails with TypeError
        raise TypeError("Expected a non-empty batch: a curve needs at least one score.")
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc = torch.sort(-preds, stable=True).indices
    preds = preds[desc]
    target = target[desc]
    weight = sample_weights[desc] if sample_weights is not None else 1.0

    # the host read of the curve: how many distinct scores there are
    distinct_idx = torch.nonzero(preds[1:] - preds[:-1])[:, 0]
    threshold_idxs = torch.cat([distinct_idx, torch.tensor([target.shape[0] - 1], device=preds.device)])
    target = (target == pos_label).to(torch.int32)
    # float32 cumulative sums, as in the JAX package (int32 * 1.0 is float32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]
    if sample_weights is not None:
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = 1 + threshold_idxs - tps
    return fps, tps, preds[threshold_idxs]


def _precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, Optional[int]]:
    """Normalize inputs to (flat) binary or ``[N', C]`` layout."""
    if preds.ndim == target.ndim:
        if pos_label is None:
            rank_zero_warn("`pos_label` automatically set 1.")
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in metric"
                    f" `precision_recall_curve` but detected {preds.shape[1]} number of classes from predictions"
                )
            preds = preds.transpose(0, 1).reshape(num_classes, -1).transpose(0, 1)
            target = target.transpose(0, 1).reshape(num_classes, -1).transpose(0, 1)
        else:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
    elif preds.ndim == target.ndim + 1:
        if pos_label is not None:
            rank_zero_warn(
                f"Argument `pos_label` should be `None` when running multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in metric"
                f" `precision_recall_curve` but detected {preds.shape[1]} number of classes from predictions"
            )
        preds = preds.transpose(0, 1).reshape(num_classes, -1).transpose(0, 1)
        target = target.reshape(-1)
    else:
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")
    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute_single_class(
    preds: torch.Tensor,
    target: torch.Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    fps, tps, thresholds = _binary_clf_curve(preds, target, sample_weights, pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # stop when full recall is attained (the second host read), and reverse
    # so that recall decreases
    last_ind = int(torch.nonzero(tps == tps[-1])[0, 0])
    sl = slice(0, last_ind + 1)
    precision = torch.cat([precision[sl].flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall[sl].flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    thresholds = thresholds[sl].flip(0)
    return precision, recall, thresholds


def _precision_recall_curve_compute_multi_class(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    precision, recall, thresholds = [], [], []
    for cls in range(num_classes):
        preds_cls = preds[:, cls]
        prc_args = dict(preds=preds_cls, target=target, num_classes=1, pos_label=cls, sample_weights=sample_weights)
        if target.ndim > 1:
            prc_args.update(dict(target=target[:, cls], pos_label=1))
        res = precision_recall_curve(**prc_args)
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])
    return precision, recall, thresholds


def _precision_recall_curve_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[
    Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]],
]:
    if num_classes == 1:
        if pos_label is None:
            pos_label = 1
        return _precision_recall_curve_compute_single_class(preds, target, pos_label, sample_weights)
    return _precision_recall_curve_compute_multi_class(preds, target, num_classes, sample_weights)


def precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[
    Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]],
]:
    """Exact precision–recall pairs at every distinct score.

    Args:
        preds: binary scores ``[N]`` or per-class scores ``[N, C]``.
        target: labels of the matching shape.
        num_classes: class count for multiclass scores.
        pos_label: the label treated as positive in binary input.
        sample_weights: optional per-sample weights for the counts.

    Returns:
        ``(precision, recall, thresholds)``: tensors for binary input,
        per-class lists for multiclass; precision and recall end with the
        (1, 0) point, so they are one longer than thresholds.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision_recall_curve
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precisions, recalls, thresholds = precision_recall_curve(pred, target, pos_label=1)
        >>> [round(p, 4) for p in precisions.tolist()]
        [0.6667, 0.5, 0.0, 1.0]
    """
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
