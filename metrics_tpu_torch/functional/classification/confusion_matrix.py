"""Confusion matrix: one scatter count per batch.

Counterpart of ``metrics_tpu/functional/classification/confusion_matrix.py``.
Each (target, pred) pair maps to one cell index, and :func:`_bincount` counts
the indices into a zeroed int64 vector on the device, with no host read. On
CUDA the (multi-dim) multi-class count is one kernel launch
(``ops/confusion_counts.py``), which reads the scores or labels once and
builds no one-hot.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.confusion_counts import _confusion_counts_kernel
from metrics_tpu_torch.utils.checks import (
    _check_broadcastable,
    _classification_case,
    _format_classification,
    _onehot_width,
)
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.enums import DataType


def _confusion_matrix_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> torch.Tensor:
    """The int64 confusion matrix of one batch: ``[C, C]``, or ``[C, 2, 2]``
    with ``multilabel``.

    When the inputs fail validation against ``num_classes``, the classes are
    inferred from the data instead, as in the JAX package; cell indices that
    then fall outside ``[0, C*C)`` are dropped and the others may land in
    other rows (see :func:`_bincount`).

    A non-empty (multi-dim) multi-class batch with integer targets on CUDA is
    counted by the ``confusion_counts`` kernel, equal bit for bit to the
    composition (:func:`_confusion_matrix_composed`), which every other batch
    takes.
    """
    preds, target, case, classes = _validated_case(preds, target, num_classes, threshold)
    if preds.is_cuda and not multilabel:
        operands = _kernel_operands(preds, target, case, classes, num_classes)
        if operands is not None:
            preds, target, width = operands
            return _confusion_counts_kernel(preds, target, num_classes, width)
    return _confusion_matrix_composed(preds, target, case, classes, num_classes, threshold, multilabel)


def _kernel_operands(
    preds: torch.Tensor, target: torch.Tensor, case: DataType, classes: Optional[int], num_classes: int
) -> Optional[Tuple[torch.Tensor, torch.Tensor, int]]:
    """``(preds, target, width)`` as the ``confusion_counts`` kernel takes
    them, for a validated non-empty (multi-dim) multi-class pair with integer
    targets; ``None`` for any other pair. ``width`` is the one-hot width of
    the composition's formatting."""
    if (
        num_classes < 1
        or case not in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS)
        or target.numel() == 0
        or target.is_floating_point()
        or target.is_complex()
        or preds.is_complex()
        or preds.is_floating_point() and preds.dtype not in (torch.float32, torch.float64)
    ):
        return None
    width = _onehot_width(preds, target, classes)
    if not preds.is_floating_point() and preds.dtype not in (torch.int32, torch.int64):
        preds = preds.long()
    if target.dtype not in (torch.int32, torch.int64):
        target = target.long()
    return preds.contiguous(), target.contiguous(), width


def _validated_case(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, DataType, Optional[int]]:
    """The pair validated against ``num_classes`` or, where that fails, with
    the classes inferred: ``(preds, target, case, classes)``, ``classes``
    being ``num_classes`` or ``None``."""
    try:
        return (*_classification_case(preds, target, threshold, num_classes=num_classes), num_classes)
    except ValueError:
        return (*_classification_case(preds, target, threshold), None)


def _confusion_matrix_composed(
    preds: torch.Tensor,
    target: torch.Tensor,
    case: DataType,
    classes: Optional[int],
    num_classes: int,
    threshold: float,
    multilabel: bool,
) -> torch.Tensor:
    """The count of a validated pair as a composition of tensor ops: the
    formatting's one-hots, an argmax of each back to a class, the cell index
    and :func:`_bincount`."""
    preds, target, mode = _format_classification(preds, target, case, threshold, num_classes=classes)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds = torch.argmax(preds, dim=1)
        target = torch.argmax(target, dim=1)
    if multilabel:
        _check_broadcastable(
            tuple(preds.shape), (num_classes,),
            f"`multilabel=True` needs multi-label input with {num_classes} columns",
        )
        unique_mapping = (2 * target + preds) + 4 * torch.arange(num_classes, device=preds.device)
        minlength = 4 * num_classes
    else:
        unique_mapping = target.reshape(-1) * num_classes + preds.reshape(-1)
        minlength = num_classes**2
    bins = _bincount(unique_mapping, minlength)
    if multilabel:
        return bins.reshape(num_classes, 2, 2)
    return bins.reshape(num_classes, num_classes)


def _confusion_matrix_update_plain(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> torch.Tensor:
    """:func:`_confusion_matrix_update` as the composition on any device: the
    reference that the kernel is held to."""
    preds, target, case, classes = _validated_case(preds, target, num_classes, threshold)
    return _confusion_matrix_composed(preds, target, case, classes, num_classes, threshold, multilabel)


def _confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    """Optionally normalize, in float32, over targets (``"true"``), preds
    (``"pred"``) or everything (``"all"``); 0/0 becomes 0."""
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / torch.sum(confmat, dim=1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / torch.sum(confmat, dim=0, keepdim=True)
        elif normalize == "all":
            confmat = confmat / torch.sum(confmat)
        confmat = torch.nan_to_num(confmat, nan=0.0)
    return confmat


def confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> torch.Tensor:
    """The ``[C, C]`` confusion matrix in one stateless call: rows are true
    classes, columns predicted ones (``[C, 2, 2]``, one 2x2 matrix per label,
    with ``multilabel=True``).

    Args:
        preds: labels or probabilities in any supported shape.
        target: ground-truth labels.
        num_classes: number of classes ``C``.
        normalize: ``"true"`` divides by row sums, ``"pred"`` by column sums,
            ``"all"`` by the total; ``None`` keeps the counts.
        threshold: binarization cut for probabilistic input.
        multilabel: independent binary decisions per label.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import confusion_matrix
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confusion_matrix(preds, target, num_classes=2).tolist()
        [[2, 0], [1, 1]]
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)
