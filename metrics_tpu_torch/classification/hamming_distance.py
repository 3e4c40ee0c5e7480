"""HammingDistance module metric.

Counterpart of ``metrics_tpu/classification/hamming_distance.py``: int64
correct/total "sum" states.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.hamming_distance import (
    _hamming_distance_compute,
    _hamming_distance_update,
)


class HammingDistance(Metric):
    """Hamming loss: the fraction of labels predicted wrong, each label
    scored on its own (a sample with 9 of 10 tags right adds 0.1).

    Args:
        threshold: binarization cut for probabilistic input.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HammingDistance
        >>> hamming = HammingDistance(device="cpu")
        >>> round(float(hamming(torch.tensor([[0, 1], [1, 1]]), torch.tensor([[0, 1], [0, 1]]))), 4)
        0.25
    """

    is_differentiable = False

    def __init__(
        self,
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
        self.add_state("correct", default=torch.zeros((), dtype=torch.long), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.long), dist_reduce_fx="sum")
        self.threshold = threshold

    def update_identity(self) -> Optional[Tuple]:
        """Compute-group key: the update depends on ``threshold`` alone."""
        return ("hamming_distance", self.threshold)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        correct, total = _hamming_distance_update(preds, target, self.threshold)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _hamming_distance_compute(self.correct, self.total)
