"""MSLE — functional layer.

Counterpart of ``metrics_tpu/functional/regression/mean_squared_log_error.py``.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _mean_squared_log_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    return torch.sum((torch.log1p(preds) - torch.log1p(target)) ** 2), preds.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: torch.Tensor, n_obs) -> torch.Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared log error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_log_error
        >>> round(float(mean_squared_log_error(torch.tensor([0.5, 1.0, 2.0]), torch.tensor([0.5, 2.0, 2.0]))), 4)
        0.0548
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
