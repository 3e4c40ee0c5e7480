"""Single-query normalized DCG.

Counterpart of ``metrics_tpu/functional/retrieval/ndcg.py``.
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.segment import descending_key
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs, _check_retrieval_k


def _dcg(target: torch.Tensor) -> torch.Tensor:
    denom = torch.log2(torch.arange(target.shape[-1], device=target.device) + 2.0)
    return (target / denom).sum(-1)


def retrieval_normalized_dcg(preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """nDCG with linear gain; non-binary targets allowed.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_normalized_dcg
        >>> preds = torch.tensor([0.1, 0.2, 0.3, 4.0, 70.0])
        >>> target = torch.tensor([10, 0, 0, 1, 5])
        >>> round(float(retrieval_normalized_dcg(preds, target)), 4)
        0.6957
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    k = preds.shape[-1] if k is None else k
    _check_retrieval_k(k)
    sorted_target = target[torch.argsort(descending_key(preds), stable=True)][:k]
    ideal_target = torch.sort(target, descending=True).values[:k]
    ideal_dcg = _dcg(ideal_target)
    target_dcg = _dcg(sorted_target)
    return torch.where(ideal_dcg == 0, 0.0, target_dcg / torch.where(ideal_dcg == 0, 1.0, ideal_dcg))
