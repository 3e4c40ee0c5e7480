"""Specificity module metric.

Counterpart of ``metrics_tpu/classification/specificity.py``.
"""
import torch

from metrics_tpu_torch.classification.precision_recall import _AveragedStatScores
from metrics_tpu_torch.functional.classification.specificity import _specificity_compute


class Specificity(_AveragedStatScores):
    r"""Specificity :math:`\frac{TN}{TN + FP}`, the true-negative rate: the
    mirror of :class:`~metrics_tpu_torch.Recall`. Arguments as for
    :class:`~metrics_tpu_torch.Precision`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Specificity
        >>> specificity = Specificity(num_classes=4, average="macro", device="cpu")
        >>> round(float(specificity(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))), 4)
        0.8333
    """

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _specificity_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)
