"""Intersection over union (Jaccard index), read off a confusion matrix.

Counterpart of ``metrics_tpu/functional/classification/iou.py``.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utils.checks import _check_not_empty
from metrics_tpu_torch.utils.data import get_num_classes


def _iou_from_confmat(
    confmat: torch.Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Per-class IoU = diag / (row sum + column sum - diag) in float32; a
    class with an empty union scores ``absent_score``, and ``ignore_index``'s
    row is zeroed and its score left out."""
    ignored = ignore_index is not None and 0 <= ignore_index < num_classes
    if ignored:
        confmat = confmat.clone()
        confmat[ignore_index] = 0

    intersection = torch.diag(confmat)
    union = torch.sum(confmat, dim=0) + torch.sum(confmat, dim=1) - intersection
    scores = intersection.to(torch.float32) / union.to(torch.float32)
    scores = torch.where(union == 0, torch.full_like(scores, absent_score), scores)

    if ignored:
        scores = torch.cat([scores[:ignore_index], scores[ignore_index + 1:]])
    return reduce(scores, reduction=reduction)


def iou(
    preds: torch.Tensor,
    target: torch.Tensor,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    r"""Jaccard index :math:`J(A,B) = \frac{|A\cap B|}{|A\cup B|}` per class,
    in one stateless call.

    Args:
        preds: labels or probabilities in any supported shape.
        target: ground-truth labels.
        ignore_index: class left out of the result (its predictions still
            count toward the other classes' unions).
        absent_score: the score of a class absent from preds and target.
        threshold: binarization cut for probabilistic input.
        num_classes: class count; inferred from the data (two host reads)
            when omitted, with a warning when it disagrees with the data.
        reduction: ``"elementwise_mean"``, ``"sum"`` or ``"none"``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import iou
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> round(float(iou(preds, target)), 4)
        0.5833
    """
    _check_not_empty(target)
    num_classes = get_num_classes(preds=preds, target=target, num_classes=num_classes)
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold)
    return _iou_from_confmat(confmat, num_classes, ignore_index, absent_score, reduction)
