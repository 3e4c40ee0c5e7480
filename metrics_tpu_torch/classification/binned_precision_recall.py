"""Binned (constant-memory) PR-curve family.

Counterpart of ``metrics_tpu/classification/binned_precision_recall.py``. The
state is TP/FP/FN float32 counters of shape ``[C, T]``; every update bins the
batch against the fixed thresholds through :func:`binned_stat_scores`, which
on a CUDA device is the hand-written kernel of ``csrc/binned_stats.cu``.
"""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute_with_precision_recall,
)
from metrics_tpu_torch.ops.binned_stats import binned_stat_scores
from metrics_tpu_torch.utils.data import METRIC_EPS, _linspace_like_reference, to_onehot


def _recall_at_precision(
    precision: torch.Tensor, recall: torch.Tensor, thresholds: torch.Tensor, min_precision: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest recall (and its threshold) where precision >= min_precision.

    Ties break like a lexicographic ``max((r, p, t))``: max recall, then max
    precision, then max threshold. With no such recall the threshold is 1e6.
    """
    n = thresholds.shape[0]
    prec, rec = precision[:n], recall[:n]
    ok = prec >= min_precision
    max_recall = torch.amax(torch.where(ok, rec, torch.full_like(rec, -1.0)))
    tie = ok & (rec == max_recall)
    max_prec = torch.amax(torch.where(tie, prec, torch.full_like(prec, -1.0)))
    tie = tie & (prec == max_prec)
    best_threshold = torch.amax(torch.where(tie, thresholds, torch.full_like(thresholds, float("-inf"))))
    max_recall = torch.clamp(max_recall, min=0.0)
    best_threshold = torch.where(max_recall == 0.0, torch.full_like(best_threshold, 1e6), best_threshold)
    return max_recall, best_threshold


class BinnedPrecisionRecallCurve(Metric):
    """Precision–recall curve over fixed thresholds, in constant memory.

    Args:
        num_classes: number of classes (1 for binary-style scores).
        thresholds: an int ``T`` (evenly spaced in [0, 1], the same float32
            values as the JAX package's ``jnp.linspace(0, 1.0, T)``), a 1-D
            tensor of thresholds, or a list of floats.
        compute_on_step / dist_sync_on_step / process_group / device: see
            :class:`~metrics_tpu_torch.Metric`.

    :meth:`compute` returns ``(precision, recall, thresholds)`` with the
    (1, 0) endpoint appended; per class as lists when ``num_classes > 1``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedAveragePrecision
        >>> ap = BinnedAveragePrecision(num_classes=1, thresholds=5, device="cpu")
        >>> ap.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> round(float(ap.compute()), 4)
        0.8333
    """

    def __init__(
        self,
        num_classes: int,
        thresholds: Union[int, torch.Tensor, List[float], None] = 100,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            device=device,
        )
        self.num_classes = num_classes
        if isinstance(thresholds, int):
            thr = _linspace_like_reference(thresholds)
        elif isinstance(thresholds, (list, torch.Tensor)):
            thr = torch.as_tensor(thresholds, dtype=torch.float32)
        else:
            raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
        self.num_thresholds = thr.numel()
        self.register_buffer("thresholds", thr.to(self.device).contiguous(), persistent=False)

        for name in ("TPs", "FPs", "FNs"):
            self.add_state(
                name,
                default=torch.zeros((num_classes, self.num_thresholds), dtype=torch.float32),
                dist_reduce_fx="sum",
            )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        """[N] or [N, C] probabilities vs integer / one-hot targets."""
        if preds.ndim == target.ndim == 1:
            preds = preds.reshape(-1, 1)
            target = target.reshape(-1, 1)
        if preds.ndim == target.ndim + 1:
            target = to_onehot(target, num_classes=self.num_classes)
        # the kernel takes contiguous float32 rows; a one-hot target is a
        # transposed view until made contiguous
        target = (target == 1).to(torch.float32).contiguous()
        tp, fp, fn = binned_stat_scores(preds.to(torch.float32).contiguous(), target, self.thresholds)
        self.TPs = self.TPs + tp
        self.FPs = self.FPs + fp
        self.FNs = self.FNs + fn

    def compute(
        self,
    ) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], ...]]:
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)
        # the curve ends at precision=1, recall=0
        ones = torch.ones((self.num_classes, 1), dtype=precisions.dtype, device=precisions.device)
        precisions = torch.cat([precisions, ones], dim=1)
        recalls = torch.cat([recalls, torch.zeros_like(ones)], dim=1)
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], self.thresholds
        return list(precisions), list(recalls), [self.thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Average precision from binned precision/recall pairs (a list of
    per-class values when ``num_classes > 1``)."""

    def compute(self) -> Union[List[torch.Tensor], torch.Tensor]:  # type: ignore[override]
        precisions, recalls, _ = super().compute()
        return _average_precision_compute_with_precision_recall(precisions, recalls, self.num_classes, average=None)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """Highest recall at a minimum precision, and its threshold, from binned
    precision/recall pairs (per class when ``num_classes > 1``)."""

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, torch.Tensor, List[float], None] = 100,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            thresholds=thresholds,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            device=device,
        )
        self.min_precision = min_precision

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        precisions, recalls, thresholds = super().compute()
        if self.num_classes == 1:
            return _recall_at_precision(precisions, recalls, thresholds, self.min_precision)
        recalls_at_p = []
        thresholds_at_p = []
        for i in range(self.num_classes):
            r, t = _recall_at_precision(precisions[i], recalls[i], thresholds[i], self.min_precision)
            recalls_at_p.append(r)
            thresholds_at_p.append(t)
        return torch.stack(recalls_at_p), torch.stack(thresholds_at_p)
