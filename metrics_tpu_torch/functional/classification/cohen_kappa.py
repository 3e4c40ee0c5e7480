"""Cohen's kappa, read off a confusion matrix.

Counterpart of ``metrics_tpu/functional/classification/cohen_kappa.py``, with
its float32 cast points: the counts are cast once, then the marginals, their
outer product and the weighted sums are float32.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)

_cohen_kappa_update = _confusion_matrix_update


def _cohen_kappa_compute(confmat: torch.Tensor, weights: Optional[str] = None) -> torch.Tensor:
    """kappa = 1 - sum(w * confmat) / sum(w * expected), with ``w`` the
    weighting scheme's disagreement weights."""
    confmat = _confusion_matrix_compute(confmat).to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = torch.sum(confmat, dim=0, keepdim=True)
    sum1 = torch.sum(confmat, dim=1, keepdim=True)
    expected = torch.matmul(sum1, sum0) / torch.sum(sum0)

    if weights is None:
        w_mat = 1.0 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device)
        diff = idx[None, :] - idx[:, None]
        w_mat = torch.abs(diff) if weights == "linear" else diff**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )
    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
) -> torch.Tensor:
    r"""Cohen's kappa in one stateless call: the agreement of preds and
    target, less the agreement chance would give (1 perfect, 0 chance).
    ``weights`` (``None``, ``"linear"``, ``"quadratic"``) weighs a
    disagreement by the (squared) distance of the labels, for ordinal labels.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cohen_kappa
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> round(float(cohen_kappa(preds, target, num_classes=2)), 4)
        0.5
    """
    confmat = _cohen_kappa_update(preds, target, num_classes, threshold)
    return _cohen_kappa_compute(confmat, weights)
