"""Scale-invariant SDR — functional layer.

Counterpart of ``metrics_tpu/functional/audio/si_sdr.py``.
"""
import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def si_sdr(preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False) -> torch.Tensor:
    """Scale-invariant signal-to-distortion ratio.

    Projects ``preds`` onto ``target`` (optimal scaling ``alpha``) and
    measures the residual energy ratio in dB.

    Args:
        preds: shape ``[..., time]``
        target: shape ``[..., time]``
        zero_mean: subtract the time-mean from both signals first

    Returns:
        si-sdr value of shape ``[...]``

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(si_sdr(preds, target)), 4)
        18.403
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
    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(target * target, dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    ratio = (torch.sum(target_scaled * target_scaled, dim=-1) + eps) / (torch.sum(noise * noise, dim=-1) + eps)
    return 10 * torch.log10(ratio)
