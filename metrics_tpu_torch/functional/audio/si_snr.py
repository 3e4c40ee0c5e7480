"""Scale-invariant SNR — functional layer: SI-SDR with zero mean.

Counterpart of ``metrics_tpu/functional/audio/si_snr.py``.
"""
import torch

from metrics_tpu_torch.functional.audio.si_sdr import si_sdr


def si_snr(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Scale-invariant signal-to-noise ratio.

    Args:
        preds: shape ``[..., time]``
        target: shape ``[..., time]``

    Returns:
        si-snr value of shape ``[...]``

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(si_snr(preds, target)), 4)
        15.0918
    """
    return si_sdr(preds=preds, target=target, zero_mean=True)
