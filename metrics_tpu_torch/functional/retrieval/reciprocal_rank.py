"""Single-query reciprocal rank.

Counterpart of ``metrics_tpu/functional/retrieval/reciprocal_rank.py``.
"""
import torch

from metrics_tpu_torch.ops.segment import descending_key
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_reciprocal_rank(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 / rank of the first relevant document; 0 if none.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, False])
        >>> round(float(retrieval_reciprocal_rank(preds, target)), 4)
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not bool(target.sum()):
        return torch.tensor(0.0, device=preds.device)
    relevant = target[torch.argsort(descending_key(preds), stable=True)] > 0
    first = torch.argmax(relevant.to(torch.int8))  # the first maximum
    return 1.0 / (first + 1.0)
