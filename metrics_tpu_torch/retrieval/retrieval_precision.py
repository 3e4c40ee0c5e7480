"""RetrievalPrecision (counterpart of metrics_tpu/retrieval/retrieval_precision.py)."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.ops.segment import GroupedByQuery, segment_sum
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utils.checks import _check_retrieval_k


class RetrievalPrecision(RetrievalMetric):
    """Mean precision@k over queries (k=None: the whole group).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> p2 = RetrievalPrecision(k=2, device="cpu")
        >>> round(float(p2(preds, target, indexes=indexes)), 4)
        0.5
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
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
        rel = (g.target > 0).to(torch.float32)
        if self.k is None:
            return segment_sum(rel, g) / g.group_sizes.to(torch.float32)
        return segment_sum(rel * (g.rank <= self.k), g) / float(self.k)
