"""ConfusionMatrix module metric.

Counterpart of ``metrics_tpu/classification/confusion_matrix.py``: one int64
``[C, C]`` (or ``[C, 2, 2]`` multilabel) "sum" state, filled by a scatter
count per batch.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)


class ConfusionMatrix(Metric):
    """The ``[C, C]`` count matrix, rows true classes and columns predicted
    ones; with ``multilabel=True`` one 2x2 matrix per label.

    Args:
        num_classes: number of classes ``C`` (sets the state's shape).
        normalize: at ``compute``, ``"true"`` divides by row sums, ``"pred"``
            by column sums, ``"all"`` by the total; ``None`` keeps counts.
        threshold: binarization cut for probabilistic binary/multilabel input.
        multilabel: independent binary decisions per label.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ConfusionMatrix
        >>> confmat = ConfusionMatrix(num_classes=2, device="cpu")
        >>> confmat(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 0, 0, 1])).tolist()
        [[1, 1], [0, 2]]
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel

        allowed_normalize = ("true", "pred", "all", "none", None)
        if normalize not in allowed_normalize:
            raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
        shape = (num_classes, 2, 2) if multilabel else (num_classes, num_classes)
        self.add_state("confmat", default=torch.zeros(shape, dtype=torch.long), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        self.confmat = self.confmat + _confusion_matrix_update(
            preds, target, self.num_classes, self.threshold, self.multilabel
        )

    def compute(self) -> torch.Tensor:
        return _confusion_matrix_compute(self.confmat, self.normalize)
