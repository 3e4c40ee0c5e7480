from metrics_tpu_torch.retrieval.collection import RetrievalCollection
from metrics_tpu_torch.retrieval.mean_average_precision import RetrievalMAP
from metrics_tpu_torch.retrieval.mean_reciprocal_rank import RetrievalMRR
from metrics_tpu_torch.retrieval.retrieval_fallout import RetrievalFallOut
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric
from metrics_tpu_torch.retrieval.retrieval_ndcg import RetrievalNormalizedDCG
from metrics_tpu_torch.retrieval.retrieval_precision import RetrievalPrecision
from metrics_tpu_torch.retrieval.retrieval_recall import RetrievalRecall

__all__ = [
    "RetrievalCollection",
    "RetrievalFallOut",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalRecall",
]
