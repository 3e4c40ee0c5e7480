"""MSE / RMSE — functional layer.

Counterpart of ``metrics_tpu/functional/regression/mean_squared_error.py``.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _mean_squared_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    diff = preds - target
    return torch.sum(diff * diff), preds.numel()


def _mean_squared_error_compute(sum_squared_error: torch.Tensor, n_obs, squared: bool = True) -> torch.Tensor:
    mse = sum_squared_error / n_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: torch.Tensor, target: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """Mean squared error (RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_error
        >>> round(float(mean_squared_error(torch.tensor([0.0, 1.0]), torch.tensor([1.0, 1.0]))), 4)
        0.5
    """
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared)
