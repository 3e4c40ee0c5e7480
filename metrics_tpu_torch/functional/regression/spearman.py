"""Spearman correlation — functional layer.

Counterpart of ``metrics_tpu/functional/regression/spearman.py``. The JAX
package ranks with two ``jnp.searchsorted`` passes over the sorted data,
which order NaN above every number and treat all NaNs as one tie group.
``torch.searchsorted`` does not: on ``[0.1, 0.3, 0.3, 0.9, nan, nan]`` it
puts 0.9 at 6, not 4, so the finite ranks would differ too. Here the ranks
come from one stable sort (NaN last, as ``jnp.sort``) and the tie groups of
the sorted run, with NaN tied to NaN: the same ranks, with no host read and
no float atomics (``ops/ranking.py::_group_bounds``).
"""
from typing import Tuple

import torch

from metrics_tpu_torch.ops.ranking import _group_bounds
from metrics_tpu_torch.utils.checks import _check_same_shape


def _rank_data(data: torch.Tensor) -> torch.Tensor:
    """1-based ranks with ties assigned the mean of their rank span."""
    if data.numel() == 0:  # no tie groups to bound; the mean of no ranks is NaN, as in the JAX package
        return data.to(data.dtype if data.is_floating_point() else torch.float32)
    flat = data.reshape(1, -1)
    v_sorted, order = torch.sort(flat, dim=-1, stable=True)
    nan = torch.isnan(v_sorted)
    breaks = (v_sorted[:, 1:] != v_sorted[:, :-1]) & ~(nan[:, 1:] & nan[:, :-1])
    first, last = _group_bounds(breaks)
    # the group of sorted rows [first, last] holds ranks first + 1 .. last + 1
    twice = (first + last + 2).to(data.dtype if data.is_floating_point() else torch.float32)
    ranks = torch.empty_like(twice).scatter_(-1, order, twice / 2)
    return ranks.reshape(data.shape)


def _spearman_corrcoef_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    preds = preds.squeeze()
    target = target.squeeze()
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _spearman_corrcoef_compute(preds: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    preds = _rank_data(preds)
    target = _rank_data(target)
    preds_diff = preds - torch.mean(preds)
    target_diff = target - torch.mean(target)
    cov = torch.mean(preds_diff * target_diff)
    preds_std = torch.sqrt(torch.mean(preds_diff * preds_diff))
    target_std = torch.sqrt(torch.mean(target_diff * target_diff))
    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def spearman_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Spearman rank correlation coefficient.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spearman_corrcoef
        >>> round(float(spearman_corrcoef(torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([1.0, 3.0, 2.0, 4.0]))), 4)
        0.8
    """
    preds, target = _spearman_corrcoef_update(preds, target)
    return _spearman_corrcoef_compute(preds, target)
