"""MeanSquaredError module metric.

Counterpart of ``metrics_tpu/regression/mean_squared_error.py``: a float32 sum state
and an int64 count (int32 in the JAX package).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.mean_squared_error import (
    _mean_squared_error_compute,
    _mean_squared_error_update,
)


class MeanSquaredError(Metric):
    r"""Mean squared error, or RMSE with ``squared=False`` (the square root is
    taken of the global mean at ``compute()``, not per batch). State: the
    squared-error sum and the count.

    Args:
        squared: ``False`` for the root mean squared error.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> mse = MeanSquaredError(device="cpu")
        >>> round(float(mse(torch.tensor([0.0, 1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 2.0, 2.0]))), 4)
        0.25
    """

    is_differentiable = True

    def __init__(
        self,
        squared: bool = True,
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
        self.add_state("sum_squared_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")
        self.squared = squared

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, self.squared)
