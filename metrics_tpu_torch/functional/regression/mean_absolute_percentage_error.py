"""MAPE — functional layer.

Counterpart of ``metrics_tpu/functional/regression/mean_absolute_percentage_error.py``.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor, epsilon: float = 1.17e-06
) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    abs_diff = torch.abs(preds - target)
    denominator = torch.abs(target)
    if not denominator.is_floating_point():
        # the JAX package clips an integer target with a weakly typed float:
        # the quotient keeps the float width of ``preds`` (float16 stays float16)
        denominator = denominator.to(abs_diff.dtype if abs_diff.is_floating_point() else torch.float32)
    abs_per_error = abs_diff / torch.clamp(denominator, min=epsilon)
    return torch.sum(abs_per_error), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: torch.Tensor, num_obs) -> torch.Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute percentage error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_percentage_error
        >>> round(float(mean_absolute_percentage_error(torch.tensor([9.0, 19.0]), torch.tensor([10.0, 20.0]))), 4)
        0.075
    """
    sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
