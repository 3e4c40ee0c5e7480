"""AUC module metric (area under any accumulated curve).

Counterpart of ``metrics_tpu/classification/auc.py``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.auc import _auc_compute, _auc_update
from metrics_tpu_torch.utils.data import dim_zero_cat


class AUC(Metric):
    """Area under an accumulated ``(x, y)`` curve by the trapezoidal rule.

    Args:
        reorder: sort the points by x before integrating.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUC
        >>> auc = AUC(device="cpu")
        >>> round(float(auc(torch.tensor([0.0, 1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 2.0, 2.0]))), 4)
        4.0
    """

    is_differentiable = False

    def __init__(
        self,
        reorder: bool = False,
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
        self.reorder = reorder
        self.add_state("x", default=[], dist_reduce_fx="cat")
        self.add_state("y", default=[], dist_reduce_fx="cat")

    def update(self, x: torch.Tensor, y: torch.Tensor) -> None:  # type: ignore[override]
        x, y = _auc_update(x, y)
        self.x.append(x)
        self.y.append(y)

    def compute(self) -> torch.Tensor:
        return _auc_compute(dim_zero_cat(self.x), dim_zero_cat(self.y), reorder=self.reorder)
