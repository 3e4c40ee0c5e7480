"""AverageMeter: a weighted streaming mean.

Counterpart of ``metrics_tpu/core/average.py``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric


class AverageMeter(Metric):
    """Average of a stream of (optionally weighted) values.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AverageMeter
        >>> avg = AverageMeter(device="cpu")
        >>> round(float(avg(torch.tensor([1.0, 2.0, 3.0]))), 4)
        2.0
    """

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
        self.add_state("value", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("weight", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, value: Union[torch.Tensor, float], weight: Union[torch.Tensor, float] = 1.0) -> None:  # type: ignore[override]
        """Add observations; ``weight`` broadcasts to ``value``'s shape."""
        value = self._as_float32(value)
        weight = self._as_float32(weight).broadcast_to(value.shape)
        self.value = self.value + torch.sum(value * weight)
        self.weight = self.weight + torch.sum(weight)

    def _as_float32(self, x: Union[torch.Tensor, float]) -> torch.Tensor:
        """``x`` as a float32 tensor on the metric's device; a Python number
        as a fill there (no copy from the host, so a CUDA graph capture of a
        step that updates the meter takes it)."""
        if isinstance(x, (int, float)):
            return torch.full((), x, dtype=torch.float32, device=self.device)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def compute(self) -> torch.Tensor:
        return self.value / self.weight
