"""metrics_tpu_torch — the PyTorch / CUDA port of ``metrics_tpu``.

Stateful, batch-accumulating metrics with cross-process sync on
``torch.distributed``, written for an NVIDIA H100. The JAX package
``metrics_tpu`` is the reference this package is tested against; the port
imports nothing of it.

Metrics hold their state on the CUDA device unless constructed with
``device="cpu"``; without CUDA, constructing one without ``device="cpu"``
raises.
"""
__version__ = "0.1.0"

from metrics_tpu_torch import observability
from metrics_tpu_torch.audio import PIT, SI_SDR, SI_SNR, SNR
from metrics_tpu_torch.classification import (
    AUC,
    AUROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    F1,
    FBeta,
    HammingDistance,
    Hinge,
    IoU,
    KLDivergence,
    MatthewsCorrcoef,
    Precision,
    PrecisionRecallCurve,
    ROC,
    Recall,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.core.average import AverageMeter
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.checkpoint import load_checkpoint, prune_checkpoints, save_checkpoint
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric
from metrics_tpu_torch.image import FID, IS, KID, LPIPS, PSNR, SSIM
from metrics_tpu_torch.retrieval import (
    RetrievalCollection,
    RetrievalFallOut,
    RetrievalMAP,
    RetrievalMetric,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalRecall,
)
from metrics_tpu_torch.regression import (
    CosineSimilarity,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrcoef,
    R2Score,
    SpearmanCorrcoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
)
from metrics_tpu_torch.text import WER, BERTScore, BLEUScore, ROUGEScore
from metrics_tpu_torch.wrappers import BootStrapper, MetricTracker

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AverageMeter",
    "AveragePrecision",
    "BERTScore",
    "BLEUScore",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "BootStrapper",
    "CalibrationError",
    "CatBuffer",
    "CohenKappa",
    "CompositionalMetric",
    "ConfusionMatrix",
    "CosineSimilarity",
    "ExplainedVariance",
    "F1",
    "FBeta",
    "FID",
    "HammingDistance",
    "Hinge",
    "IS",
    "IoU",
    "KID",
    "KLDivergence",
    "LPIPS",
    "MatthewsCorrcoef",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricCollection",
    "MetricTracker",
    "PIT",
    "PSNR",
    "PearsonCorrcoef",
    "Precision",
    "PrecisionRecallCurve",
    "R2Score",
    "ROC",
    "ROUGEScore",
    "Recall",
    "RetrievalCollection",
    "RetrievalFallOut",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalRecall",
    "SI_SDR",
    "SI_SNR",
    "SNR",
    "SSIM",
    "SpearmanCorrcoef",
    "Specificity",
    "StatScores",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WER",
    "load_checkpoint",
    "prune_checkpoints",
    "save_checkpoint",
]
