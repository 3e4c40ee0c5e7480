"""Accuracy module metric (top-k, subset, micro/macro/weighted/samples).

Counterpart of ``metrics_tpu/classification/accuracy.py``: a
:class:`StatScores` with extra ``correct``/``total`` states for subset
accuracy, and the input mode latched at the first update.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.accuracy import (
    _accuracy_compute,
    _accuracy_update,
    _check_subset_validity,
    _mode,
    _subset_accuracy_compute,
    _subset_accuracy_update,
)
from metrics_tpu_torch.utils.enums import DataType


class Accuracy(StatScores):
    r"""Accuracy :math:`\frac{1}{N}\sum_i^N 1(y_i = \hat{y}_i)`.

    Args:
        threshold: binarization cut for binary/multilabel probabilities.
        num_classes: number of classes; required for ``"macro"``,
            ``"weighted"`` and ``"none"``.
        average: ``"micro"``, ``"macro"``, ``"weighted"``, ``"samples"`` or
            ``"none"``.
        mdmc_average: multidim handling, ``"global"`` by default.
        ignore_index: class label excluded from scoring.
        top_k: with multiclass probabilities, a hit when the target is among
            the k best-scored classes.
        multiclass: force/forbid multiclass interpretation.
        subset_accuracy: for multilabel/multidim input, a sample scores 1
            only when every label of it is right.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> accuracy = Accuracy(num_classes=4, device="cpu")
        >>> round(float(accuracy(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))), 4)
        0.5
    """

    is_differentiable = False

    def __init__(
        self,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        average: str = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        subset_accuracy: bool = False,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )

        if average in ["weighted", "none", None] and (not num_classes or num_classes < 1):
            raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
        if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
            raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

        self.average = average
        self.subset_accuracy = subset_accuracy
        self.mode: Optional[DataType] = None

        self.add_state("correct", default=torch.zeros((), dtype=torch.long), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.long), dist_reduce_fx="sum")

    _group_shared_attrs = ("mode", "subset_accuracy")

    def update_identity(self) -> Optional[Tuple]:
        """Compute-group key: Accuracy's update (input-mode latch, the subset
        branch, extra states) groups only with Accuracy of the same
        configuration, never with the plain stat-score family."""
        return (
            "accuracy",
            self.reduce,
            self.mdmc_reduce,
            self.threshold,
            self.num_classes,
            self.top_k,
            self.multiclass,
            self.ignore_index,
            self.subset_accuracy,
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        """Accumulate either subset-accuracy counts or stat scores."""
        mode = _mode(preds, target, self.threshold, self.top_k, self.num_classes, self.multiclass)
        if self.mode is None:
            self.mode = mode
        elif self.mode != mode:
            raise ValueError(f"You can not use {mode} inputs with {self.mode} inputs.")

        if self.subset_accuracy and _check_subset_validity(self.mode):
            correct, total = _subset_accuracy_update(
                preds, target, threshold=self.threshold, top_k=self.top_k, num_classes=self.num_classes
            )
            self.correct = self.correct + correct
            self.total = self.total + total
        else:
            # input that has no subset form latches plain accuracy
            self.subset_accuracy = False
            tp, fp, tn, fn = _accuracy_update(
                preds,
                target,
                reduce=self.reduce,
                mdmc_reduce=self.mdmc_reduce,
                threshold=self.threshold,
                num_classes=self.num_classes,
                top_k=self.top_k,
                multiclass=self.multiclass,
                ignore_index=self.ignore_index,
                mode=self.mode,
            )
            self._accumulate(tp, fp, tn, fn)

    def compute(self) -> torch.Tensor:
        """Final accuracy over all accumulated batches."""
        if self.subset_accuracy:
            return _subset_accuracy_compute(self.correct, self.total)
        tp, fp, tn, fn = self._get_final_stats()
        return _accuracy_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce, self.mode)
