"""KL divergence — functional layer.

Counterpart of ``metrics_tpu/functional/classification/kl_divergence.py``.
"""
from typing import Optional, Tuple
from warnings import warn

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import METRIC_EPS


def _kld_update(p: torch.Tensor, q: torch.Tensor, log_prob: bool) -> Tuple[torch.Tensor, int]:
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")
    total = p.shape[0]
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / torch.sum(p, dim=-1, keepdim=True)
        q = q / torch.sum(q, dim=-1, keepdim=True)
        q = torch.clamp_min(q, METRIC_EPS)
        measures = torch.sum(p * torch.log(p / q), dim=-1)
    return measures, total


def _kld_compute(measures: torch.Tensor, total: torch.Tensor, reduction: Optional[str] = "mean") -> torch.Tensor:
    if reduction == "sum":
        return torch.sum(measures)
    if reduction == "mean":
        return torch.sum(measures) / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(
    p: torch.Tensor, q: torch.Tensor, log_prob: bool = False, reduction: Optional[str] = "mean"
) -> torch.Tensor:
    r"""KL divergence :math:`D_{KL}(P||Q) = \sum_x P(x)\log\frac{P(x)}{Q(x)}`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import kl_divergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> round(float(kl_divergence(p, q)), 4)
        0.0853
    """
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, torch.tensor(total, device=measures.device), reduction)


def kldivergence(
    p: torch.Tensor, q: torch.Tensor, log_prob: bool = False, reduction: Optional[str] = "mean"
) -> torch.Tensor:
    """Deprecated alias of :func:`kl_divergence`: warns, then calls it.

    Example:
        >>> import warnings
        >>> import torch
        >>> from metrics_tpu_torch.functional import kldivergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> with warnings.catch_warnings():
        ...     warnings.simplefilter("ignore", DeprecationWarning)
        ...     round(float(kldivergence(p, q)), 4)
        0.0853
    """
    warn(
        "`functional.kldivergence` was renamed to `functional.kl_divergence` and will be removed.",
        DeprecationWarning,
    )
    return kl_divergence(p, q, log_prob, reduction)
