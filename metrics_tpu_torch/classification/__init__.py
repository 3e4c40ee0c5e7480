from metrics_tpu_torch.classification.accuracy import Accuracy
from metrics_tpu_torch.classification.binned_precision_recall import (
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.cohen_kappa import CohenKappa
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.classification.f_beta import F1, FBeta
from metrics_tpu_torch.classification.hamming_distance import HammingDistance
from metrics_tpu_torch.classification.iou import IoU
from metrics_tpu_torch.classification.matthews_corrcoef import MatthewsCorrcoef
from metrics_tpu_torch.classification.precision_recall import Precision, Recall
from metrics_tpu_torch.classification.specificity import Specificity
from metrics_tpu_torch.classification.stat_scores import StatScores

__all__ = [
    "Accuracy",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "CohenKappa",
    "ConfusionMatrix",
    "F1",
    "FBeta",
    "HammingDistance",
    "IoU",
    "MatthewsCorrcoef",
    "Precision",
    "Recall",
    "Specificity",
    "StatScores",
]
