"""SSIM module metric.

Counterpart of ``metrics_tpu/image/ssim.py``. With ``data_range`` given and
a mean or sum reduction (``_streaming``) each batch's SSIM map is reduced
into two float32 sum states: constant memory. Otherwise every input is
buffered in list states, since ``data_range=None`` needs the range of all
the data. The count ``total`` is float32, as in the JAX package.
"""
from typing import Any, Callable, Optional, Sequence, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.ssim import _ssim_compute, _ssim_map, _ssim_update
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class SSIM(Metric):
    r"""Structural Similarity Index Measure, accumulated over batches.

    Args:
        kernel_size: gaussian window size (h, w).
        sigma: gaussian window std (h, w).
        reduction: 'elementwise_mean' | 'sum' | 'none'.
        data_range: value range; ``None`` takes it from all the data at
            ``compute()``, which buffers every input.
        k1 / k2: SSIM stability constants.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SSIM
        >>> preds = torch.full((1, 1, 16, 16), 0.5)
        >>> round(float(SSIM(data_range=1.0, device="cpu")(preds, preds.clone())), 4)
        1.0
    """

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
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
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction
        # each batch's map is independent of the others only with a fixed
        # range, and the final reduction must distribute over batches
        self._streaming = data_range is not None and reduction in ("elementwise_mean", "sum")
        if self._streaming:
            self.add_state("similarity_sum", torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            rank_zero_warn(
                "Metric `SSIM` will save all targets and predictions in buffer"
                " (data_range=None or reduction='none'). For large datasets this"
                " may lead to large memory footprint."
            )
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        preds, target = _ssim_update(preds, target)
        if self._streaming:
            sim = _ssim_map(preds, target, self.kernel_size, self.sigma, self.data_range, self.k1, self.k2)
            self.similarity_sum = self.similarity_sum + sim.sum()
            self.total = self.total + sim.numel()  # float32 + int: a float32 count
        else:
            self.preds.append(preds)
            self.target.append(target)

    def compute(self) -> torch.Tensor:
        if self._streaming:
            if self.reduction == "sum":
                return self.similarity_sum
            return self.similarity_sum / self.total
        return _ssim_compute(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.kernel_size, self.sigma, self.reduction,
            self.data_range, self.k1, self.k2,
        )
