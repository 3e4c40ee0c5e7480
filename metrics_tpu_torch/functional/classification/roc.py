"""ROC curve — functional layer.

Counterpart of ``metrics_tpu/functional/classification/roc.py``. Each binary
curve reads the data on the host three times: the distinct scores of
``_binary_clf_curve`` and the two checks that the targets hold a negative and
a positive; a multi-class curve does so once per class.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_clf_curve,
    _precision_recall_curve_update,
)

_roc_update = _precision_recall_curve_update


def _roc_compute_single_class(
    preds: torch.Tensor,
    target: torch.Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    fps, tps, thresholds = _binary_clf_curve(preds, target, sample_weights, pos_label)
    # prepend a point so that the curve starts at (0, 0)
    tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
    fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
    thresholds = torch.cat([thresholds[0:1] + 1, thresholds])

    if fps[-1] <= 0:
        raise ValueError("No negative samples in targets, false positive value should be meaningless")
    fpr = fps / fps[-1]
    if tps[-1] <= 0:
        raise ValueError("No positive samples in targets, true positive value should be meaningless")
    tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def _roc_compute_multi_class(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    fpr, tpr, thresholds = [], [], []
    for cls in range(num_classes):
        if preds.shape == target.shape:
            target_cls, pos_label = target[:, cls], 1
        else:
            target_cls, pos_label = target, cls
        res = roc(preds[:, cls], target_cls, num_classes=1, pos_label=pos_label, sample_weights=sample_weights)
        fpr.append(res[0])
        tpr.append(res[1])
        thresholds.append(res[2])
    return fpr, tpr, thresholds


def _roc_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[
    Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]],
]:
    if num_classes == 1 and preds.ndim == 1:
        if pos_label is None:
            pos_label = 1
        return _roc_compute_single_class(preds, target, pos_label, sample_weights)
    return _roc_compute_multi_class(preds, target, num_classes, sample_weights)


def roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[
    Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]],
]:
    """Receiver-operating-characteristic curve: one sort, cumulative sums of
    hits and misses at each distinct score, and the (0, 0) origin prepended.

    Args:
        preds: binary scores ``[N]``, or per-class scores ``[N, C]``.
        target: labels ``[N]`` (binary/multiclass) or ``[N, C]``
            (multilabel).
        num_classes: class count for multiclass scores.
        pos_label: label counted as positive for binary input.
        sample_weights: optional per-sample weights of the counts.

    Returns:
        ``(fpr, tpr, thresholds)`` tensors for binary input, three lists of
        one tensor per class otherwise. ``thresholds[0]`` is one above the
        best score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import roc
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> fpr, tpr, thresholds = roc(pred, target, pos_label=1)
        >>> fpr.tolist()
        [0.0, 0.0, 0.0, 0.0, 1.0]
    """
    preds, target, num_classes, pos_label = _roc_update(preds, target, num_classes, pos_label)
    return _roc_compute(preds, target, num_classes, pos_label, sample_weights)
