"""AUROC module metric.

Counterpart of ``metrics_tpu/classification/auroc.py``, with the same
compute dispatch: after ``with_capacity`` the binary, multiclass and
multilabel modes compute by ranking over the buffer (``ops/ranking.py``),
one batched sort for all classes; list states (and ``max_fpr``, and the
modes ranking does not cover) build one ROC curve per class. Which path runs
follows from the metric's configuration, as in the JAX package. The
compute-group hooks of the JAX module (``update_identity``,
``_group_shared_attrs``) wait for compute groups.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.ops.ranking import masked_binary_auroc, masked_multiclass_auroc, masked_multilabel_auroc
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import DataType


def _filled_rows(preds: CatBuffer, target: CatBuffer) -> Tuple[torch.Tensor, torch.Tensor]:
    """The filled rows of two CatBuffers, as views. The fill count is known on
    the host, so the ranking runs on these rows with no mask; the buffers'
    overflow flag reaches the result through ``poison``."""
    return preds.buffer[: preds.count], target.buffer[: target.count]


class AUROC(Metric):
    r"""Area under the ROC curve: the probability that a random positive
    scores above a random negative.

    Scores and targets accumulate as "cat" states; the areas are formed at
    :meth:`compute`. By default the states are lists of batches and each
    class's ROC curve is built and integrated. After
    :meth:`~metrics_tpu_torch.Metric.with_capacity` they are fixed-capacity
    buffers, and binary, multiclass and multilabel AUROC (without
    ``max_fpr``) are computed by tie-averaged Mann–Whitney ranking instead:
    the same value, ties included, except that a class absent from the data
    scores 0.5 there where the curve path raises.

    Args:
        num_classes: number of classes for multiclass scores ``[N, C]``;
            ``None`` for binary ``[N]`` scores.
        pos_label: the label counted as positive for binary input (default 1).
        average: ``"macro"``, ``"weighted"`` (by support), ``"micro"``
            (multilabel only) or ``None`` for the per-class vector.
        max_fpr: integrate only up to this false-positive rate, with the
            McClish correction (binary only).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUROC
        >>> auroc = AUROC(device="cpu")
        >>> round(float(auroc(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))), 4)
        0.75
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
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
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (None, "macro", "weighted", "micro")
        if average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        self.mode: Optional[DataType] = None
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    _group_shared_attrs = ("mode",)

    def update_identity(self) -> Optional[Tuple]:
        """Compute-group key: ``_auroc_update`` takes no configuration, so any
        AUROC members share one preds/target accumulation (``average`` and
        ``num_classes`` shape only ``compute``). Not the curve family's key:
        that update reshapes where this one stores rows as they are."""
        return ("auroc",)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        preds, target, mode = _auroc_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)
        if self.mode is not None and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def compute(self) -> torch.Tensor:
        preds_cb, target_cb = self.preds, self.target
        if isinstance(preds_cb, CatBuffer) and self.max_fpr is None:
            if self.mode == DataType.BINARY and self.pos_label in (None, 1):
                if preds_cb.buffer is None:
                    raise ValueError("No samples to concatenate")
                return preds_cb.poison(masked_binary_auroc(*_filled_rows(preds_cb, target_cb)))
            # one-vs-rest over [N, C] scores: integer targets (multi-dim
            # multiclass rows were flattened by the update) or binary [N, C]
            if (
                preds_cb.buffer is not None
                and preds_cb.buffer.ndim == 2
                and self.average != "micro"
                and self.mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS)
                and target_cb.buffer.ndim == 1
            ):
                return preds_cb.poison(masked_multiclass_auroc(*_filled_rows(preds_cb, target_cb), None, self.average))
            if (
                preds_cb.buffer is not None
                and preds_cb.buffer.ndim == 2
                and self.mode == DataType.MULTILABEL
                and target_cb.buffer.ndim == 2
            ):
                return preds_cb.poison(masked_multilabel_auroc(*_filled_rows(preds_cb, target_cb), None, self.average))
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _auroc_compute(preds, target, self.mode, self.num_classes, self.pos_label, self.average, self.max_fpr)
