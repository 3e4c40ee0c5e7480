from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric

__all__ = ["CompositionalMetric", "Metric", "MetricCollection"]
