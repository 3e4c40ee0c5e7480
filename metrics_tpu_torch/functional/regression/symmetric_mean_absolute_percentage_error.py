"""SMAPE — functional layer.

Counterpart of
``metrics_tpu/functional/regression/symmetric_mean_absolute_percentage_error.py``.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _symmetric_mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor, epsilon: float = 1.17e-06
) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    abs_per_error = 2 * torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error: torch.Tensor, num_obs) -> torch.Tensor:
    return sum_abs_per_error / num_obs


def symmetric_mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Symmetric mean absolute percentage error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import symmetric_mean_absolute_percentage_error
        >>> smape = symmetric_mean_absolute_percentage_error(torch.tensor([9.0, 19.0]), torch.tensor([10.0, 20.0]))
        >>> round(float(smape), 4)
        0.0783
    """
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
