"""SI_SNR module metric.

Counterpart of ``metrics_tpu/audio/si_snr.py``: a float32 sum of the
per-signal values and an int64 count (int32 in the JAX package, which
widens on load).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.si_snr import si_snr


class SI_SNR(Metric):
    r"""Scale-invariant signal-to-noise ratio, averaged over signals.

    Forward accepts ``preds``/``target`` of shape ``[..., time]``.

    Args:
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SI_SNR
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(SI_SNR(device="cpu")(preds, target)), 4)
        15.0918
    """

    is_differentiable = True

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.add_state("sum_si_snr", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        batch_vals = si_snr(preds=preds, target=target)
        self.sum_si_snr = self.sum_si_snr + torch.sum(batch_vals)
        self.total = self.total + batch_vals.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_si_snr / self.total
