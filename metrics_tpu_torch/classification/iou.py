"""IoU (Jaccard index) module metric.

Counterpart of ``metrics_tpu/classification/iou.py``: a
:class:`ConfusionMatrix` read off at ``compute``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.iou import _iou_from_confmat


class IoU(ConfusionMatrix):
    r"""Intersection over union :math:`\frac{TP}{TP + FP + FN}` per class,
    from the accumulated confusion matrix.

    Args:
        num_classes: number of classes ``C``.
        ignore_index: class left out of the result (its predictions still
            count toward the other classes' unions).
        absent_score: the score of a class absent from preds and target.
        threshold: binarization cut for probabilistic input.
        reduction: ``"elementwise_mean"``, ``"sum"`` or ``"none"``.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import IoU
        >>> iou = IoU(num_classes=2, device="cpu")
        >>> round(float(iou(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 0, 0, 1]))), 4)
        0.5833
    """

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        reduction: str = "elementwise_mean",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            normalize=None,
            threshold=threshold,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.reduction = reduction
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def compute(self) -> torch.Tensor:
        return _iou_from_confmat(self.confmat, self.num_classes, self.ignore_index, self.absent_score, self.reduction)
