"""MatthewsCorrcoef module metric.

Counterpart of ``metrics_tpu/classification/matthews_corrcoef.py``. Its
``[C, C]`` confusion-matrix state is float32, as in the JAX package: the
counts it adds are exact up to 2**24 per cell.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)


class MatthewsCorrcoef(Metric):
    """Matthews correlation coefficient: the correlation of predicted and
    true labels over the whole accumulated confusion matrix (1 perfect, 0
    chance, -1 total disagreement); robust under class imbalance. A
    degenerate marginal (a stream of one class) gives NaN, as in the JAX
    package and sklearn.

    Args:
        num_classes: number of classes ``C``.
        threshold: binarization cut for probabilistic input.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MatthewsCorrcoef
        >>> matthews = MatthewsCorrcoef(num_classes=2, device="cpu")
        >>> round(float(matthews(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 0, 0, 1]))), 4)
        0.5774
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: int,
        threshold: float = 0.5,
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
        self.threshold = threshold
        self.add_state(
            "confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.float32), dist_reduce_fx="sum"
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        self.confmat = self.confmat + _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> torch.Tensor:
        return _matthews_corrcoef_compute(self.confmat)
