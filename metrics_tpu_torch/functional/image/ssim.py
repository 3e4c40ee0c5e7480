"""Structural Similarity Index Measure — functional layer.

Counterpart of ``metrics_tpu/functional/image/ssim.py``. The windowed
statistics are one depthwise ``conv2d`` (``groups=C``) over the five
stacked planes (x, y, x², y², xy), after a reflect pad; the crop then drops
the padded border. On the card the convolution is cuDNN's, run as true
float32 (``utils/device.py::full_float32``).
"""
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metrics_tpu_torch.parallel.sync import reduce
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.device import full_float32


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """1D gaussian window ``[1, kernel_size]``, from ``arange((1-k)/2,
    (1+k)/2)`` in ``dtype`` as the JAX package."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, dtype=dtype, device=device)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return (gauss / gauss.sum()).unsqueeze(0)


def _gaussian_kernel(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """Separable 2D gaussian per channel, ``[C, 1, kh, kw]`` for a depthwise conv."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype, device)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel = kernel_x.T @ kernel_y  # (kh, kw)
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1])


def _ssim_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate the inputs: one dtype, one BxCxHxW shape."""
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ssim_map(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Per-pixel SSIM map ``[B, C, H - 2·pad_h, W - 2·pad_w]``, before the
    final reduction. With ``data_range=None`` the range is taken from the
    batch: the larger of the two inputs' ``max - min``."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    dtype, device = preds.dtype, preds.device
    if data_range is None:
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
        c1, c2 = torch.square(k1 * data_range), torch.square(k2 * data_range)
    else:  # k·range in double, squared in float32, as jnp.square of a Python float; no copy to the card
        c1, c2 = (float(np.square(np.float32(k * data_range))) for k in (k1, k2))

    channel = preds.shape[1]
    kernel = _gaussian_kernel(channel, kernel_size, sigma, dtype, device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    pad = (pad_w, pad_w, pad_h, pad_h)
    preds_p = F.pad(preds, pad, mode="reflect")
    target_p = F.pad(target, pad, mode="reflect")

    # one depthwise conv over the five stacked planes
    planes = torch.cat([preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p])
    with full_float32():
        outputs = F.conv2d(planes, kernel, groups=channel)
    mu_x, mu_y, sq_x, sq_y, xy = outputs.chunk(5)

    mu_x_sq = mu_x * mu_x
    mu_y_sq = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = sq_x - mu_x_sq
    sigma_y = sq_y - mu_y_sq
    sigma_xy = xy - mu_xy

    upper = 2 * sigma_xy + c2
    lower = sigma_x + sigma_y + c2
    ssim_idx = ((2 * mu_xy + c1) * upper) / ((mu_x_sq + mu_y_sq + c1) * lower)
    return ssim_idx[..., pad_h: ssim_idx.shape[-2] - pad_h, pad_w: ssim_idx.shape[-1] - pad_w]


def _ssim_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """SSIM with its final reduction."""
    return reduce(_ssim_map(preds, target, kernel_size, sigma, data_range, k1, k2), reduction)


def ssim(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural Similarity Index Measure.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import ssim
        >>> img = torch.arange(256.0).reshape(1, 1, 16, 16) / 255.0
        >>> round(float(ssim(img, img * 0.9 + 0.05)), 4)
        0.9945
    """
    preds, target = _ssim_update(preds, target)
    return _ssim_compute(preds, target, kernel_size, sigma, reduction, data_range, k1, k2)
