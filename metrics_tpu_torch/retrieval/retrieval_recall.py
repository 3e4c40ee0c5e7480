"""RetrievalRecall (counterpart of metrics_tpu/retrieval/retrieval_recall.py)."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.ops.segment import GroupedByQuery, segment_sum
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utils.checks import _check_retrieval_k


class RetrievalRecall(RetrievalMetric):
    """Mean recall@k over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRecall
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> r2 = RetrievalRecall(k=2, device="cpu")
        >>> round(float(r2(preds, target, indexes=indexes)), 4)
        0.75
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
        in_topk = rel if self.k is None else rel * (g.rank <= self.k)
        npos = segment_sum(rel, g)
        return segment_sum(in_topk, g) / npos.clamp(min=1.0)
