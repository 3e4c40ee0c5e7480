"""Single-query retrieval AP.

Counterpart of ``metrics_tpu/functional/retrieval/average_precision.py``.
"""
import torch

from metrics_tpu_torch.ops.segment import descending_key
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_average_precision(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """AP of one query's predictions; 0 if no positive target.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_average_precision(preds, target)), 4)
        0.8333
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not bool(target.sum()):
        return torch.tensor(0.0, device=preds.device)
    rel = target[torch.argsort(descending_key(preds), stable=True)] > 0
    positions = torch.arange(1, rel.shape[0] + 1, dtype=torch.float32, device=preds.device)
    cum_rel = rel.cumsum(0)
    return torch.where(rel, cum_rel / positions, 0.0).sum() / rel.sum()
