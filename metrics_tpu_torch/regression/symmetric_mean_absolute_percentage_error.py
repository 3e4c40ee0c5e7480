"""SymmetricMeanAbsolutePercentageError module metric.

Counterpart of ``metrics_tpu/regression/symmetric_mean_absolute_percentage_error.py``: a float32 sum state
and an int64 count (int32 in the JAX package).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.symmetric_mean_absolute_percentage_error import (
    _symmetric_mean_absolute_percentage_error_compute,
    _symmetric_mean_absolute_percentage_error_update,
)


class SymmetricMeanAbsolutePercentageError(Metric):
    r"""SMAPE accumulated over batches.

    Args:
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SymmetricMeanAbsolutePercentageError
        >>> smape = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> round(float(smape(torch.tensor([1.0, 10.0, 1e6]), torch.tensor([0.9, 15.0, 1.2e6]))), 4)
        0.229
    """

    is_differentiable = True

    def __init__(
        self,
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
        self.add_state("sum_abs_per_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        sum_abs_per_error, n_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _symmetric_mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)
