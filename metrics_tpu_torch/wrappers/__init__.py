from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from metrics_tpu_torch.wrappers.tracker import MetricTracker

__all__ = ["BootStrapper", "MetricTracker"]
