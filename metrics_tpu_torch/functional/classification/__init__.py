from metrics_tpu_torch.functional.classification.accuracy import accuracy
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores

__all__ = ["accuracy", "stat_scores"]
