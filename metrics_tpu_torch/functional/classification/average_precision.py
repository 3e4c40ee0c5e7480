"""Average precision from precision/recall pairs.

Counterpart of ``metrics_tpu/functional/classification/average_precision.py:57-85``
(``_average_precision_compute_with_precision_recall``); the rest of that
module belongs to the cat-state curve family, which a later slice ports.
"""
import warnings
from typing import List, Optional, Union

import torch


def _average_precision_compute_with_precision_recall(
    precision: Union[torch.Tensor, List[torch.Tensor]],
    recall: Union[torch.Tensor, List[torch.Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
) -> Union[List[torch.Tensor], torch.Tensor]:
    """AP = -sum(dRecall * precision) — the step-function integral."""
    if num_classes == 1:
        return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])

    res = [-torch.sum((r[1:] - r[:-1]) * p[:-1]) for p, r in zip(precision, recall)]

    if average in ("macro", "weighted"):
        res_arr = torch.stack(res)
        if bool(torch.isnan(res_arr).any()):
            warnings.warn(
                "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
                UserWarning,
            )
        valid = ~torch.isnan(res_arr)
        if average == "macro":
            return torch.mean(res_arr[valid])
        weights = torch.ones_like(res_arr) if weights is None else weights
        return torch.sum((res_arr * weights)[valid])
    if average is None:
        return res
    allowed_average = ("micro", "macro", "weighted", None)
    raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")
