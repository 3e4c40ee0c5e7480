"""Explained variance — functional layer.

Counterpart of ``metrics_tpu/functional/regression/explained_variance.py``:
streaming moments, with ``where`` selects for a zero numerator or
denominator.
"""
from typing import Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _explained_variance_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_same_shape(preds, target)
    n_obs = preds.shape[0]
    diff = target - preds
    sum_error = torch.sum(diff, dim=0)
    sum_squared_error = torch.sum(diff * diff, dim=0)
    sum_target = torch.sum(target, dim=0)
    sum_squared_target = torch.sum(target * target, dim=0)
    return n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target


def _explained_variance_compute(
    n_obs: Union[int, torch.Tensor],
    sum_error: torch.Tensor,
    sum_squared_error: torch.Tensor,
    sum_target: torch.Tensor,
    sum_squared_target: torch.Tensor,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    safe_den = torch.where(valid_score, denominator, torch.ones_like(denominator))
    output_scores = torch.where(valid_score, 1.0 - numerator / safe_den, torch.ones_like(diff_avg))
    output_scores = torch.where(
        nonzero_numerator & ~nonzero_denominator, torch.zeros_like(output_scores), output_scores
    )

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(
        "Argument `multioutput` must be either `raw_values`, `uniform_average` or"
        f" `variance_weighted`. Received {multioutput}."
    )


def explained_variance(
    preds: torch.Tensor,
    target: torch.Tensor,
    multioutput: str = "uniform_average",
) -> Union[torch.Tensor, Sequence[torch.Tensor]]:
    """Explained variance score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import explained_variance
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(explained_variance(preds, target)), 4)
        0.9572
    """
    n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target, multioutput
    )
