"""R² score — functional layer.

Counterpart of ``metrics_tpu/functional/regression/r2.py``.
"""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, _is_concrete
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _r2_score_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {tuple(preds.shape)}"
        )
    sum_obs = torch.sum(target, dim=0)
    sum_squared_obs = torch.sum(target * target, dim=0)
    residual = target - preds
    rss = torch.sum(residual * residual, dim=0)
    return sum_squared_obs, sum_obs, rss, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    n_obs: Union[int, torch.Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    # the count decides the checks below: one host read of a state, eager
    # only (a compiled forward's batch count follows from its input shapes,
    # and its program's eager warm-up made this check)
    count = int(n_obs) if not isinstance(n_obs, torch.Tensor) or _is_concrete(n_obs) else None
    if count is not None and count < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")

    mean_obs = sum_obs / n_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    raw_scores = 1 - (rss / tss)

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        r2 = torch.sum(tss / torch.sum(tss) * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0 and count is None:
        r2 = torch.where(n_obs - 1 > adjusted, 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1), r2)
    elif adjusted != 0:
        n_obs = count
        if adjusted > n_obs - 1:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score."
                " Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == n_obs - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            r2 = 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
    return r2


def r2_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    r"""R² :math:`1 - \frac{\sum_i (y_i - \hat{y}_i)^2}{\sum_i (y_i - \bar{y})^2}`:
    the fraction of target variance the predictions explain.

    Args:
        preds: predictions ``[N]``, or ``[N, D]`` for several outputs.
        target: ground truth of the same shape.
        adjusted: when ``> 0``, the degrees-of-freedom correction for this
            many regressors.
        multioutput: how the ``[D]`` per-output scores collapse:
            ``"uniform_average"``, ``"raw_values"`` or ``"variance_weighted"``.

    Raises:
        ValueError: fewer than two samples, a negative or non-int
            ``adjusted``, or an unknown ``multioutput``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import r2_score
        >>> round(float(r2_score(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.9486
    """
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, n_obs, adjusted, multioutput)
