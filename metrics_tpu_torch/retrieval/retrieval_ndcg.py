"""RetrievalNormalizedDCG (counterpart of metrics_tpu/retrieval/retrieval_ndcg.py;
non-binary targets allowed)."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.ops.segment import GroupedByQuery, relevance_sorted, segment_sum
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.utils.checks import _check_retrieval_k


class RetrievalNormalizedDCG(RetrievalMetric):
    """Mean nDCG@k over queries; linear gain, log2 discount.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalNormalizedDCG
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> ndcg = RetrievalNormalizedDCG(device="cpu")
        >>> round(float(ndcg(preds, target, indexes=indexes)), 4)
        0.9599
    """

    allow_non_binary_target = True

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

    def _dcg(self, target: torch.Tensor, rank: torch.Tensor, g: GroupedByQuery) -> torch.Tensor:
        gain = target / torch.log2(rank + 1.0)
        return segment_sum(gain if self.k is None else torch.where(rank <= self.k, gain, 0.0), g)

    def _segment_metric(self, g: GroupedByQuery) -> torch.Tensor:
        dcg = self._dcg(g.target, g.rank, g)
        idcg = self._dcg(*relevance_sorted(g), g)
        return torch.where(idcg == 0, 0.0, dcg / torch.where(idcg == 0, 1.0, idcg))
