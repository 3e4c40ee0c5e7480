"""Matthews correlation coefficient, read off a confusion matrix.

Counterpart of ``metrics_tpu/functional/classification/matthews_corrcoef.py``:
the marginals, trace and total are summed in the matrix's dtype, then cast to
float32.
"""
import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: torch.Tensor) -> torch.Tensor:
    tk = torch.sum(confmat, dim=1).to(torch.float32)
    pk = torch.sum(confmat, dim=0).to(torch.float32)
    c = torch.trace(confmat).to(torch.float32)
    s = torch.sum(confmat).to(torch.float32)
    return (c * s - torch.sum(tk * pk)) / (
        torch.sqrt(s**2 - torch.sum(pk * pk)) * torch.sqrt(s**2 - torch.sum(tk * tk))
    )


def matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    threshold: float = 0.5,
) -> torch.Tensor:
    r"""Matthews correlation coefficient in one stateless call: the
    correlation of predicted and true labels over the full confusion matrix
    (1 perfect, 0 chance, -1 total disagreement; NaN when a marginal is
    degenerate, as in the JAX package and sklearn).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import matthews_corrcoef
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> round(float(matthews_corrcoef(preds, target, num_classes=2)), 4)
        0.5774
    """
    confmat = _matthews_corrcoef_update(preds, target, num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)
