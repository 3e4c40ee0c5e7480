"""AveragePrecision module metric.

Counterpart of ``metrics_tpu/classification/average_precision.py``, with the
same compute dispatch: after ``with_capacity`` binary and multiclass average
precision are computed by ranking over the buffer (``ops/ranking.py``), one
batched sort for all classes; list states (and multilabel input) build one
precision–recall curve per class. The compute-group hooks of the JAX module
wait for compute groups.
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification.auroc import _filled_rows
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.ops.ranking import masked_binary_average_precision, masked_multiclass_average_precision
from metrics_tpu_torch.utils.data import dim_zero_cat


class AveragePrecision(Metric):
    r"""Average precision :math:`\sum_k (R_k - R_{k-1}) P_k`: the area under
    the precision–recall step curve.

    Scores and targets accumulate as "cat" states (lists of batches, or
    fixed-capacity buffers after ``with_capacity``, which compute by
    ranking for binary and multiclass input).

    Args:
        num_classes: number of classes for multiclass scores ``[N, C]``;
            ``None`` for binary ``[N]``.
        pos_label: the label treated as positive in binary input.
        average: ``"macro"``, ``"weighted"``, ``"micro"`` or ``None``
            (per-class list).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AveragePrecision
        >>> average_precision = AveragePrecision(device="cpu")
        >>> round(float(average_precision(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))), 4)
        0.8333
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
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
        allowed_average = ("micro", "macro", "weighted", None)
        if average not in allowed_average:
            raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")
        self.average = average
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    _group_shared_attrs = ("num_classes", "pos_label")

    def update_identity(self) -> Optional[Tuple]:
        """Compute-group key: for every ``average`` but ``"micro"`` the update
        is the curve family's ``_precision_recall_curve_update``, so it shares
        ROC's and PrecisionRecallCurve's key; ``"micro"`` also ravels
        multilabel input and groups only with other micro instances."""
        if self.average == "micro":
            return ("clf_curve_micro", self.num_classes, self.pos_label)
        return ("clf_curve", self.num_classes, self.pos_label)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label, self.average
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[torch.Tensor, List[torch.Tensor]]:
        preds_cb, target_cb = self.preds, self.target
        if isinstance(preds_cb, CatBuffer):
            if self.num_classes == 1 and self.pos_label == 1:
                if preds_cb.buffer is None:
                    raise ValueError("No samples to concatenate")
                preds, target = _filled_rows(preds_cb, target_cb)
                # binarize as the curve path does (`target == pos_label`)
                return preds_cb.poison(masked_binary_average_precision(preds, target == self.pos_label))
            if (
                preds_cb.buffer is not None
                and preds_cb.buffer.ndim == 2
                and target_cb.buffer.ndim == 1
                and self.average != "micro"
            ):
                res = preds_cb.poison(
                    masked_multiclass_average_precision(*_filled_rows(preds_cb, target_cb), None, self.average)
                )
                if self.average is None:
                    # a list of per-class values, as the curve path returns
                    return list(res.unbind(0))
                return res
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _average_precision_compute(preds, target, self.num_classes, self.pos_label, self.average)
