"""Hinge loss (binary, Crammer-Singer, one-vs-all) — functional layer.

Counterpart of ``metrics_tpu/functional/classification/hinge.py``.
"""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _input_squeeze
from metrics_tpu_torch.utils.data import to_onehot
from metrics_tpu_torch.utils.enums import DataType, EnumStr


class MulticlassMode(EnumStr):
    """Multiclass hinge flavors."""

    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


def _check_shape_and_type_consistency_hinge(preds: torch.Tensor, target: torch.Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.")
    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                f"The `preds` and `target` should have the same shape, got `preds` with shape={tuple(preds.shape)}"
                f" and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.BINARY
    elif preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                f"The `preds` and `target` should have the same shape in the first dimension, got `preds` with"
                f" shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        mode = DataType.MULTICLASS
    else:
        raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}.")
    return mode


def _hinge_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of hinge measures over the batch, and the sample count."""
    preds, target = _input_squeeze(preds, target)
    mode = _check_shape_and_type_consistency_hinge(preds, target)
    if mode == DataType.MULTICLASS:
        target_onehot = to_onehot(target, max(2, preds.shape[1])).to(torch.bool)
    if mode == DataType.MULTICLASS and (multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER):
        own = torch.sum(torch.where(target_onehot, preds, torch.zeros_like(preds)), dim=1)
        best_other = torch.amax(torch.where(target_onehot, torch.full_like(preds, float("-inf")), preds), dim=1)
        margin = own - best_other
    elif mode == DataType.BINARY:
        margin = torch.where(target.to(torch.bool), preds, -preds)
    elif multiclass_mode == MulticlassMode.ONE_VS_ALL:
        margin = torch.where(target_onehot, preds, -preds)
    else:
        raise ValueError(
            "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
            f"(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL, got {multiclass_mode}."
        )
    measures = torch.clamp_min(1 - margin, 0)
    if squared:
        measures = measures ** 2
    total = torch.tensor(target.shape[0], device=preds.device)
    return torch.sum(measures, dim=0), total


def _hinge_compute(measure: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return measure / total


def hinge(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> torch.Tensor:
    r"""Mean hinge loss :math:`\max(0, 1 - \text{margin})`.

    Binary decision values ``[N]`` score against targets {0, 1} (mapped to
    ±1). Multiclass scores ``[N, C]`` use ``multiclass_mode``:
    ``None``/``"crammer-singer"`` takes the true class's margin over the
    best wrong class; ``"one-vs-all"`` scores one binary hinge per class and
    returns ``[C]``. ``squared=True`` squares each per-sample loss.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import hinge
        >>> round(float(hinge(torch.tensor([-2.2, 2.4, 0.1]), torch.tensor([0, 1, 1]))), 4)
        0.3
    """
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)
