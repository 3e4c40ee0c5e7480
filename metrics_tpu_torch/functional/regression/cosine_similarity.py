"""Cosine similarity — functional layer.

Counterpart of ``metrics_tpu/functional/regression/cosine_similarity.py``.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _cosine_similarity_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(
    preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum"
) -> torch.Tensor:
    dot_product = torch.sum(preds * target, dim=-1)
    preds_norm = torch.linalg.norm(preds, dim=-1)
    target_norm = torch.linalg.norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    if reduction == "sum":
        return torch.sum(similarity)
    if reduction == "mean":
        return torch.mean(similarity)
    if reduction in ("none", None):
        return similarity
    raise ValueError(f"Expected reduction to be one of ['sum', 'mean', 'none'] but got {reduction}")


def cosine_similarity(preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    r"""Cosine similarity between rows of preds and target.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cosine_similarity
        >>> preds = torch.tensor([[3.0, 4.0], [1.0, 0.0]])
        >>> target = torch.tensor([[6.0, 8.0], [0.0, 1.0]])
        >>> cosine_similarity(preds, target, reduction=None).tolist()
        [1.0, 0.0]
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
