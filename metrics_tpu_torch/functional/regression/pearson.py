"""Pearson correlation — functional layer.

Counterpart of ``metrics_tpu/functional/regression/pearson.py``: running
moments (means, co-moment sums and the count), updated per batch.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _floating(x: torch.Tensor) -> torch.Tensor:
    """An integer input as float32, as ``jnp.mean`` promotes it."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _sub(x: torch.Tensor, moment: torch.Tensor) -> torch.Tensor:
    """``x - moment`` in the dtype the JAX package's promotion of the two
    gives: an integer target against a float16 moment stays float16, a half
    batch against a float32 moment becomes float32. Torch would keep a
    dimensioned tensor's width against a 0-d one."""
    dtype = torch.promote_types(x.dtype, moment.dtype)
    return x.to(dtype) - moment.to(dtype)


def _pearson_corrcoef_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    n_prior: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streaming-moments step; no host read."""
    _check_same_shape(preds, target)
    preds = preds.squeeze()
    target = target.squeeze()
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    n_obs = preds.numel()
    mx_new = (n_prior * mean_x + torch.mean(_floating(preds)) * n_obs) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + torch.mean(_floating(target)) * n_obs) / (n_prior + n_obs)
    n_new = n_prior + n_obs
    var_x = var_x + torch.sum(_sub(preds, mx_new) * _sub(preds, mean_x))
    var_y = var_y + torch.sum(_sub(target, my_new) * _sub(target, mean_y))
    corr_xy = corr_xy + torch.sum(_sub(preds, mx_new) * _sub(target, mean_y))
    return mx_new, my_new, var_x, var_y, corr_xy, n_new


def _pearson_corrcoef_compute(
    var_x: torch.Tensor, var_y: torch.Tensor, corr_xy: torch.Tensor, nb: torch.Tensor
) -> torch.Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = (corr_xy / torch.sqrt(var_x * var_y)).squeeze()
    return torch.clamp(corrcoef, -1.0, 1.0)


def pearson_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pearson_corrcoef
        >>> round(float(pearson_corrcoef(torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([2.0, 4.0, 6.0, 9.0]))), 4)
        0.9944
    """
    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    zero = torch.zeros((), dtype=dtype, device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, zero, zero, zero, zero, zero, zero)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
