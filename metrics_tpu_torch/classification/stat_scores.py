"""StatScores module metric — stateful tp/fp/tn/fn accumulator.

Counterpart of ``metrics_tpu/classification/stat_scores.py``. States are
int64 "sum" tensors unless ``reduce='samples'`` / ``mdmc_reduce='samplewise'``,
which accumulate per-batch tensors as list states.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.stat_scores import (
    _stat_scores_compute,
    _stat_scores_update,
)
from metrics_tpu_torch.utils.data import dim_zero_cat


class StatScores(Metric):
    """True/false positives/negatives and support — the shared accumulator
    of the Accuracy/Precision/Recall family.

    Args:
        threshold: binarization cut for binary/multilabel probabilities.
        top_k: with multiclass probabilities, one-hot the k best classes.
        reduce: ``"micro"`` one global tp/fp/tn/fn quartet, ``"macro"`` a
            ``[C]`` quartet per class, ``"samples"`` a quartet per sample.
        num_classes: number of classes ``C``; required for ``"macro"``.
        ignore_index: class label whose rows/columns drop out of every count.
        mdmc_reduce: multidim policy (``"global"``, ``"samplewise"``, ``None``).
        multiclass: force/forbid multiclass interpretation.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    :meth:`compute` returns ``[..., 5]``: ``[tp, fp, tn, fn, support]``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StatScores
        >>> stat_scores = StatScores(reduce="micro", num_classes=2, device="cpu")
        >>> stat_scores(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 0, 0, 1])).tolist()
        [3, 1, 3, 1, 4]
    """

    is_differentiable = False

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        multiclass: Optional[bool] = None,
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
        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.multiclass = multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if reduce not in ["micro", "macro", "samples"]:
            raise ValueError(f"The `reduce` {reduce} is not valid.")
        if mdmc_reduce not in [None, "samplewise", "global"]:
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        for s in ("tp", "fp", "tn", "fn"):
            if mdmc_reduce != "samplewise" and reduce != "samples":
                shape = () if reduce == "micro" else (num_classes,)
                self.add_state(s, default=torch.zeros(shape, dtype=torch.long), dist_reduce_fx="sum")
            else:
                self.add_state(s, default=[], dist_reduce_fx=None)

    def update_identity(self) -> Optional[Tuple]:
        """Compute-group key of the stat-score family: every metric that
        inherits this ``update`` unchanged (Precision, Recall, FBeta/F1,
        Specificity, StatScores) folds a batch through the same
        ``_stat_scores_update`` call, parameterized by these arguments alone,
        so collection members with equal keys share one tp/fp/tn/fn
        accumulation. A subclass that overrides ``update`` (``Accuracy``) is
        excluded unless it declares its own key."""
        return (
            "stat_scores",
            self.reduce,
            self.mdmc_reduce,
            self.threshold,
            self.num_classes,
            self.top_k,
            self.multiclass,
            self.ignore_index,
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        """Accumulate tp/fp/tn/fn from a batch of (preds, target)."""
        tp, fp, tn, fn = _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
        )
        self._accumulate(tp, fp, tn, fn)

    def _accumulate(self, tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> None:
        if isinstance(self.tp, list):
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)
        else:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn

    def _get_final_stats(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Concatenate list states (samplewise) or pass through sum states."""
        if isinstance(self.tp, list):
            return dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.tn), dim_zero_cat(self.fn)
        return self.tp, self.fp, self.tn, self.fn

    def compute(self) -> torch.Tensor:
        """Return the ``(..., 5)`` tensor of ``[tp, fp, tn, fn, support]``."""
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)
