"""Single-query recall@k.

Counterpart of ``metrics_tpu/functional/retrieval/recall.py``.
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.segment import descending_key
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs, _check_retrieval_k


def retrieval_recall(preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """Fraction of relevant documents retrieved in the top ``k``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_recall(preds, target, k=2)), 4)
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if k is None:
        k = preds.shape[-1]
    _check_retrieval_k(k)
    if not bool(target.sum()):
        return torch.tensor(0.0, device=preds.device)
    relevant = target[torch.argsort(descending_key(preds), stable=True)][:k].sum().to(torch.float32)
    return relevant / target.sum()
