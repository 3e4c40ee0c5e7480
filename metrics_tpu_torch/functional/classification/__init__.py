from metrics_tpu_torch.functional.classification.accuracy import accuracy
from metrics_tpu_torch.functional.classification.auc import auc
from metrics_tpu_torch.functional.classification.auroc import auroc
from metrics_tpu_torch.functional.classification.average_precision import average_precision
from metrics_tpu_torch.functional.classification.calibration_error import calibration_error
from metrics_tpu_torch.functional.classification.cohen_kappa import cohen_kappa
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix
from metrics_tpu_torch.functional.classification.dice import dice_score
from metrics_tpu_torch.functional.classification.f_beta import f1, fbeta
from metrics_tpu_torch.functional.classification.hamming_distance import hamming_distance
from metrics_tpu_torch.functional.classification.hinge import hinge
from metrics_tpu_torch.functional.classification.iou import iou
from metrics_tpu_torch.functional.classification.kl_divergence import kl_divergence
from metrics_tpu_torch.functional.classification.matthews_corrcoef import matthews_corrcoef
from metrics_tpu_torch.functional.classification.precision_recall import precision, precision_recall, recall
from metrics_tpu_torch.functional.classification.precision_recall_curve import precision_recall_curve
from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.functional.classification.specificity import specificity
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores

__all__ = [
    "accuracy",
    "auc",
    "auroc",
    "average_precision",
    "calibration_error",
    "cohen_kappa",
    "confusion_matrix",
    "dice_score",
    "f1",
    "fbeta",
    "hamming_distance",
    "hinge",
    "iou",
    "kl_divergence",
    "matthews_corrcoef",
    "precision",
    "precision_recall",
    "precision_recall_curve",
    "recall",
    "roc",
    "specificity",
    "stat_scores",
]
