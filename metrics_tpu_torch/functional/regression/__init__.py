from metrics_tpu_torch.functional.regression.cosine_similarity import cosine_similarity
from metrics_tpu_torch.functional.regression.explained_variance import explained_variance
from metrics_tpu_torch.functional.regression.mean_absolute_error import mean_absolute_error
from metrics_tpu_torch.functional.regression.mean_absolute_percentage_error import (
    mean_absolute_percentage_error,
)
from metrics_tpu_torch.functional.regression.mean_squared_error import mean_squared_error
from metrics_tpu_torch.functional.regression.mean_squared_log_error import mean_squared_log_error
from metrics_tpu_torch.functional.regression.pearson import pearson_corrcoef
from metrics_tpu_torch.functional.regression.r2 import r2_score
from metrics_tpu_torch.functional.regression.r2score import r2score
from metrics_tpu_torch.functional.regression.spearman import spearman_corrcoef
from metrics_tpu_torch.functional.regression.symmetric_mean_absolute_percentage_error import (
    symmetric_mean_absolute_percentage_error,
)
from metrics_tpu_torch.functional.regression.tweedie_deviance import tweedie_deviance_score

__all__ = [
    "cosine_similarity",
    "explained_variance",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "pearson_corrcoef",
    "r2_score",
    "r2score",
    "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
]
