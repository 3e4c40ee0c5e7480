"""Signal-to-noise ratio — functional layer.

Counterpart of ``metrics_tpu/functional/audio/snr.py``: vectorised over
every leading dimension, reduced over the last (time).
"""
import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def snr(preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False) -> torch.Tensor:
    r"""Signal-to-noise ratio: :math:`10 \log_{10}(P_{signal} / P_{noise})`.

    Args:
        preds: shape ``[..., time]``
        target: shape ``[..., time]``
        zero_mean: subtract the time-mean from both signals first

    Returns:
        snr value of shape ``[...]``; ``eps`` is the machine epsilon of the
        input's dtype, as in the JAX package.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(snr(preds, target)), 4)
        16.1805
    """
    _check_same_shape(preds, target)
    # eps in the preds' own width, as the JAX package's typed ``jnp.finfo(...).eps``
    # (an integer target meets it in half precision there); a 0-d CPU tensor
    # promotes as a scalar beside a CUDA tensor and launches nothing
    eps = torch.tensor(torch.finfo(preds.dtype).eps, dtype=preds.dtype)
    if zero_mean:
        # an integer signal is averaged as a float32 one, as ``jnp.mean`` promotes it
        target = target if target.is_floating_point() else target.to(torch.float32)
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    noise = target - preds
    ratio = (torch.sum(target * target, dim=-1) + eps) / (torch.sum(noise * noise, dim=-1) + eps)
    return 10 * torch.log10(ratio)
