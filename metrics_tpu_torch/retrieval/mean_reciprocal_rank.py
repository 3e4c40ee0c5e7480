"""RetrievalMRR (counterpart of ``metrics_tpu/retrieval/mean_reciprocal_rank.py``)."""
import torch

from metrics_tpu_torch.ops.segment import GroupedByQuery, segment_min
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric

#: The JAX package's "no relevant row" rank: int32 max.
_BIG = 2**31 - 1


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank of the first relevant document per query.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> mrr = RetrievalMRR(device="cpu")
        >>> round(float(mrr(preds, target, indexes=indexes)), 4)
        1.0
    """

    def _segment_metric(self, g: GroupedByQuery) -> torch.Tensor:
        first_rel_rank = segment_min(torch.where(g.target > 0, g.rank, _BIG), g)
        # an empty group's minimum is int64's max here, int32's (_BIG) there
        return torch.where(first_rel_rank >= _BIG, 0.0, 1.0 / first_rel_rank)
