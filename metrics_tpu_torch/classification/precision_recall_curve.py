"""PrecisionRecallCurve module metric.

Counterpart of ``metrics_tpu/classification/precision_recall_curve.py``:
preds and targets accumulate as "cat" states (lists, or CatBuffers after
``with_capacity``), and ``compute()`` builds the curve from all of them.
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utils.data import dim_zero_cat


class PrecisionRecallCurve(Metric):
    """Exact precision–recall pairs at every distinct score threshold.

    Args:
        num_classes: class count for multiclass scores ``[N, C]``; ``None``
            for binary ``[N]``.
        pos_label: the label treated as positive in binary input.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    :meth:`compute` returns ``(precision, recall, thresholds)``: tensors for
    binary input, per-class lists for multiclass, with the final (1, 0) point.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PrecisionRecallCurve
        >>> pr_curve = PrecisionRecallCurve(pos_label=1, device="cpu")
        >>> precision, recall, thresholds = pr_curve(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> recall.tolist()
        [1.0, 0.5, 0.5, 0.0]
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
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
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    _group_shared_attrs = ("num_classes", "pos_label")

    def update_identity(self) -> Optional[Tuple]:
        """Compute-group key of the curve family (see ``ROC``)."""
        return ("clf_curve", self.num_classes, self.pos_label)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(
        self,
    ) -> Union[
        Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
        Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]],
    ]:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _precision_recall_curve_compute(preds, target, self.num_classes, self.pos_label)
