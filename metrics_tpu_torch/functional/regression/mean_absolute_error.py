"""MAE — functional layer.

Counterpart of ``metrics_tpu/functional/regression/mean_absolute_error.py``.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _mean_absolute_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    return torch.sum(torch.abs(preds - target)), preds.numel()


def _mean_absolute_error_compute(sum_abs_error: torch.Tensor, n_obs) -> torch.Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_error
        >>> round(float(mean_absolute_error(torch.tensor([0.0, 1.0, 2.0]), torch.tensor([0.5, 1.0, 2.5]))), 4)
        0.3333
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)
