"""Hinge module metric.

Counterpart of ``metrics_tpu/classification/hinge.py``: a sum and a count
state.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.hinge import MulticlassMode, _hinge_compute, _hinge_update


class Hinge(Metric):
    r"""Mean hinge loss :math:`\max(0, 1 - y \cdot \hat{y})` over the stream.

    Binary input takes raw decision values ``[N]`` against targets {0, 1}
    (mapped to ±1). Multiclass input ``[N, C]`` takes its margin by
    ``multiclass_mode``: ``None``/``"crammer-singer"``, the true class
    against the best wrong class; ``"one-vs-all"``, one binary hinge per
    class, returned as ``[C]``.

    Args:
        squared: square each per-sample loss before averaging.
        multiclass_mode: see above.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Hinge
        >>> hinge = Hinge(device="cpu")
        >>> round(float(hinge(torch.tensor([-2.2, 2.4, 0.1]), torch.tensor([0, 1, 1]))), 4)
        0.3
    """

    is_differentiable = True
    _weak_dtype_states = ("measure",)

    def __init__(
        self,
        squared: bool = False,
        multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
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
        self.add_state("measure", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")
        if multiclass_mode not in (None, MulticlassMode.CRAMMER_SINGER, MulticlassMode.ONE_VS_ALL):
            raise ValueError(
                "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
                f"(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL, got {multiclass_mode}."
            )
        self.squared = squared
        self.multiclass_mode = multiclass_mode

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        measure, total = _hinge_update(preds, target, squared=self.squared, multiclass_mode=self.multiclass_mode)
        self.measure = measure + self.measure
        self.total = total + self.total

    def compute(self) -> torch.Tensor:
        return _hinge_compute(self.measure, self.total)
