"""Hamming distance: the fraction of labels predicted wrong.

Counterpart of ``metrics_tpu/functional/classification/hamming_distance.py``.
"""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _input_format_classification


def _hamming_distance_update(
    preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5
) -> Tuple[torch.Tensor, int]:
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)
    return torch.sum(preds == target), preds.numel()


def _hamming_distance_compute(correct: torch.Tensor, total: Union[int, torch.Tensor]) -> torch.Tensor:
    return 1 - correct.to(torch.float32) / total


def hamming_distance(preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Hamming loss in one stateless call: each label scored on its own
    (subset accuracy, by contrast, scores a sample all or nothing).
    ``threshold`` binarizes probabilistic input.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import hamming_distance
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> round(float(hamming_distance(preds, target)), 4)
        0.25
    """
    correct, total = _hamming_distance_update(preds, target, threshold)
    return _hamming_distance_compute(correct, total)
