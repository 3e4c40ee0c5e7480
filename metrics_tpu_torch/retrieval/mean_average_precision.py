"""RetrievalMAP (counterpart of ``metrics_tpu/retrieval/mean_average_precision.py``)."""
import torch

from metrics_tpu_torch.ops.segment import GroupedByQuery, segment_cumsum, segment_sum
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric


class RetrievalMAP(RetrievalMetric):
    """Mean average precision over queries (vectorized over all groups).

    The running count of relevant rows is an exact integer sum (the JAX
    package's float32 running sum is exact below 2**24 rows).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> rmap = RetrievalMAP(device="cpu")
        >>> round(float(rmap(preds, target, indexes=indexes)), 4)
        0.9167
    """

    def _segment_metric(self, g: GroupedByQuery) -> torch.Tensor:
        relevant = g.target > 0
        cum_rel = segment_cumsum(relevant, g).to(torch.float32)
        contrib = torch.where(relevant, cum_rel / g.rank, 0.0)
        npos = segment_sum(relevant.to(torch.float32), g)
        return segment_sum(contrib, g) / npos.clamp(min=1.0)
