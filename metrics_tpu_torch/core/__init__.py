from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric

__all__ = ["Metric", "MetricCollection"]
