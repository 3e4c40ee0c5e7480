"""Peak signal-to-noise ratio — functional layer.

Counterpart of ``metrics_tpu/functional/image/psnr.py``: ``_psnr_update``
returns the sufficient statistics (sum of squared error, observation
count), which the module metric accumulates as sum states.
"""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _psnr_compute(
    sum_squared_error: torch.Tensor,
    n_obs: torch.Tensor,
    data_range: torch.Tensor,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """PSNR from the accumulated statistics, in float32 as the JAX package
    (``log(base)`` of a float32 ``base``)."""
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    log_base = torch.log(torch.full((), base, dtype=torch.float32, device=psnr_base_e.device))
    psnr_vals = psnr_base_e * (10 / log_base)
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of squared error and number of observations, over everything or
    per ``dim`` slice. The count is an integer tensor, as the JAX package's
    int32 one (made on the device: ``torch.full``, not a copy from the
    host)."""
    diff = preds - target
    if dim is None:
        return torch.sum(diff * diff), torch.full((), target.numel(), device=target.device)
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:  # jnp.sum over no axes reduces nothing
        return diff * diff, torch.full((), target.numel(), device=target.device)
    sum_squared_error = torch.sum(diff * diff, dim=dim_list)
    n = 1
    for d in dim_list:
        n *= target.shape[d]
    return sum_squared_error, torch.full(sum_squared_error.shape, n, device=target.device)


def psnr(
    preds: torch.Tensor,
    target: torch.Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> torch.Tensor:
    """Peak signal-to-noise ratio.

    Args:
        preds: estimated signal.
        target: ground-truth signal.
        data_range: value range of the data; ``target.max() - target.min()``
            when ``None`` (which ``dim`` does not allow).
        base: logarithm base.
        reduction: 'elementwise_mean' | 'sum' | 'none' over per-slice scores.
        dim: dimensions to reduce over; ``None`` = all.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import psnr
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(psnr(pred, target)), 4)
        2.5527
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.max() - target.min()
    else:
        data_range = torch.full((), float(data_range), dtype=torch.float32, device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
