"""Confusion matrix: one scatter count per batch.

Counterpart of ``metrics_tpu/functional/classification/confusion_matrix.py``.
Each (target, pred) pair maps to one cell index, and :func:`_bincount` counts
the indices into a zeroed int64 vector on the device, with no host read.
"""
from typing import Optional

import torch

from metrics_tpu_torch.utils.checks import _check_broadcastable, _input_format_classification
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
    """
    try:
        preds, target, mode = _input_format_classification(preds, target, threshold, num_classes=num_classes)
    except ValueError:
        preds, target, mode = _input_format_classification(preds, target, threshold)
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
