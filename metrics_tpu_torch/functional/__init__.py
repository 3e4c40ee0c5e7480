from metrics_tpu_torch.functional.classification import accuracy, stat_scores

__all__ = ["accuracy", "stat_scores"]
