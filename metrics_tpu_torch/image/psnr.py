"""PSNR module metric.

Counterpart of ``metrics_tpu/image/psnr.py``. With ``dim=None`` the states
are scalar sums (constant memory); with ``dim`` set, lists of per-slice
statistics; without ``data_range``, min/max-reduced range trackers. Every
float state is float32, the count ``total`` too, as in the JAX package: a
JAX checkpoint loads unchanged, and past 2**24 pixels the count rounds as
the JAX package's does.
"""
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.utils.prints import rank_zero_warn


class PSNR(Metric):
    r"""Peak signal-to-noise ratio, accumulated over batches.

    Args:
        data_range: value range of the input; tracked from the targets when
            ``None`` (which ``dim`` does not allow).
        base: logarithm base.
        reduction: 'elementwise_mean' | 'sum' | 'none' over per-``dim`` scores.
        dim: dimensions to reduce over; ``None`` = all (scalar states).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PSNR
        >>> preds = torch.tensor([[[[0.0, 1.0], [2.0, 3.0]]]])
        >>> target = torch.tensor([[[[3.0, 2.0], [1.0, 0.0]]]])
        >>> round(float(PSNR(device="cpu")(preds, target)), 4)
        2.5527
    """

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
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
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")

        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", torch.tensor(0.0), dist_reduce_fx="min")
            self.add_state("max_target", torch.tensor(0.0), dist_reduce_fx="max")
        else:
            # the same on every rank, so "max" is the reference's "mean" under
            # sync, with an exact merge for forward and merge_state
            self.add_state("data_range", torch.tensor(float(data_range)), dist_reduce_fx="max")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs  # float32 + int: a float32 count
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> torch.Tensor:
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error, total = self.sum_squared_error, self.total
        else:
            sum_squared_error = torch.cat([v.reshape(-1) for v in self.sum_squared_error])
            total = torch.cat([v.reshape(-1) for v in self.total])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
