from metrics_tpu_torch.regression.cosine_similarity import CosineSimilarity
from metrics_tpu_torch.regression.explained_variance import ExplainedVariance
from metrics_tpu_torch.regression.mean_absolute_error import MeanAbsoluteError
from metrics_tpu_torch.regression.mean_absolute_percentage_error import MeanAbsolutePercentageError
from metrics_tpu_torch.regression.mean_squared_error import MeanSquaredError
from metrics_tpu_torch.regression.mean_squared_log_error import MeanSquaredLogError
from metrics_tpu_torch.regression.pearson import PearsonCorrcoef
from metrics_tpu_torch.regression.r2 import R2Score
from metrics_tpu_torch.regression.spearman import SpearmanCorrcoef
from metrics_tpu_torch.regression.symmetric_mean_absolute_percentage_error import (
    SymmetricMeanAbsolutePercentageError,
)
from metrics_tpu_torch.regression.tweedie_deviance import TweedieDevianceScore

__all__ = [
    "CosineSimilarity",
    "ExplainedVariance",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "PearsonCorrcoef",
    "R2Score",
    "SpearmanCorrcoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
]
