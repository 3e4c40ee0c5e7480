"""RetrievalFallOut (counterpart of metrics_tpu/retrieval/retrieval_fallout.py;
the empty-query policy is keyed on queries with no NEGATIVE targets)."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.ops.segment import GroupedByQuery, segment_sum
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utils.checks import _check_retrieval_k


class RetrievalFallOut(RetrievalMetric):
    """Mean fall-out@k: non-relevant retrieved / all non-relevant.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalFallOut
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> fo2 = RetrievalFallOut(k=2, device="cpu")
        >>> round(float(fo2(preds, target, indexes=indexes)), 4)
        0.5
    """

    higher_is_better = False
    empty_on_negatives = True

    def __init__(
        self,
        empty_target_action: str = "pos",
        k: Optional[int] = None,
        num_queries: Optional[int] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            empty_target_action=empty_target_action,
            num_queries=num_queries,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        _check_retrieval_k(k)
        self.k = k

    def _segment_metric(self, g: GroupedByQuery) -> torch.Tensor:
        nonrel = (g.target == 0).to(torch.float32)
        in_topk = nonrel if self.k is None else nonrel * (g.rank <= self.k)
        nneg = segment_sum(nonrel, g)
        return segment_sum(in_topk, g) / nneg.clamp(min=1.0)
