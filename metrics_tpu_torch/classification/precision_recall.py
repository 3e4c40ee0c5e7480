"""Precision and Recall module metrics.

Counterpart of ``metrics_tpu/classification/precision_recall.py``: both
accumulate the tp/fp/tn/fn states of :class:`StatScores` and reduce them at
``compute``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.precision_recall import (
    _check_prf_args,
    _precision_compute,
    _recall_compute,
)


class _AveragedStatScores(StatScores):
    """A :class:`StatScores` whose ``reduce`` follows from ``average``: per
    class for ``"weighted"``/``"none"``."""

    is_differentiable = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        # mdmc_average and ignore_index are checked by StatScores
        _check_prf_args(average, None, num_classes, None)
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
        self.average = average


class Precision(_AveragedStatScores):
    r"""Precision :math:`\frac{TP}{TP + FP}`: how much of what the model
    flagged positive was positive.

    Args:
        num_classes: number of classes ``C``; required for the per-class
            averages (``"macro"``, ``"weighted"``, ``"none"``).
        threshold: binarization cut for binary/multilabel probabilities.
        average: ``"micro"`` pools every decision, ``"macro"`` averages the
            per-class scores, ``"weighted"`` weights them by support,
            ``"samples"`` scores per sample, ``"none"``/``None`` returns the
            ``[C]`` vector (nan for classes absent from preds and target).
        mdmc_average: multidim policy: ``"global"`` flattens the extra
            dimension, ``"samplewise"`` averages per-sample scores.
        ignore_index: class label excluded from every count.
        top_k: with multiclass probabilities, a hit is the target among the
            k best classes.
        multiclass: force/forbid multiclass interpretation.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision
        >>> precision = Precision(num_classes=4, average="macro", device="cpu")
        >>> round(float(precision(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))), 4)
        0.5
    """

    def compute(self) -> torch.Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _precision_compute(tp, fp, fn, self.average, self.mdmc_reduce)


class Recall(_AveragedStatScores):
    r"""Recall :math:`\frac{TP}{TP + FN}`: how much of what is positive the
    model found. Arguments as for :class:`Precision`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Recall
        >>> recall = Recall(num_classes=3, average="weighted", device="cpu")
        >>> recall.update(torch.tensor([0, 1, 1, 2]), torch.tensor([0, 1, 2, 2]))
        >>> round(float(recall.compute()), 4)
        0.75
    """

    def compute(self) -> torch.Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _recall_compute(tp, fp, fn, self.average, self.mdmc_reduce)
