"""MeanAbsoluteError module metric.

Counterpart of ``metrics_tpu/regression/mean_absolute_error.py``: a float32 sum state
and an int64 count (int32 in the JAX package).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.mean_absolute_error import (
    _mean_absolute_error_compute,
    _mean_absolute_error_update,
)


class MeanAbsoluteError(Metric):
    r"""MAE accumulated over batches.

    Args:
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsoluteError
        >>> mae = MeanAbsoluteError(device="cpu")
        >>> round(float(mae(torch.tensor([0.0, 1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 2.0, 2.0]))), 4)
        0.25
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
        self.add_state("sum_abs_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
