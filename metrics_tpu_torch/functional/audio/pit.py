"""Permutation-invariant training (PIT) — functional layer.

Counterpart of ``metrics_tpu/functional/audio/pit.py``:

- the pairwise metric matrix is **one** call of the metric over all
  ``spk²`` (estimate, target) pairs, flattened into the batch dimension;
- up to 6 speakers (720 permutations) the best permutation is an
  exhaustive search over the static ``[spk!, spk]`` permutation table: one
  gather, a mean and an ``argmax``/``argmin`` that takes the first best, as
  ``jnp.argmax`` does;
- above 6 speakers scipy's ``linear_sum_assignment`` solves each sample on
  the host, after one device-to-host copy of the ``[batch, spk, spk]``
  matrix; the permutation goes back to the matrix's device.
"""
from functools import lru_cache
from itertools import permutations
from typing import Callable, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.checks import _check_same_shape

# exhaustive search up to 6 speakers (720 permutations); Hungarian beyond
_MAX_EXHAUSTIVE_SPK = 6


@lru_cache(maxsize=None)
def _perm_table(spk_num: int, device: torch.device) -> torch.Tensor:
    """Static [spk!, spk] table on ``device``, made once per device (a copy to
    the card per call would read the host); row p maps target t -> estimate
    perm[p, t]. Callers index it and never write it."""
    return torch.as_tensor(np.asarray(list(permutations(range(spk_num))), dtype=np.int64), device=device)


def _metric_matrix(preds: torch.Tensor, target: torch.Tensor, metric_func: Callable, **kwargs) -> torch.Tensor:
    """[batch, target_spk, est_spk] pairwise metric values in one call."""
    batch, spk = target.shape[0], target.shape[1]
    tail = tuple(target.shape[2:])
    # pair every target t with every estimate e: [batch, spk_t, spk_e, ...]
    flat_t = target[:, :, None].expand((batch, spk, spk) + tail).reshape((batch * spk * spk,) + tail)
    flat_e = preds[:, None, :].expand((batch, spk, spk) + tail).reshape((batch * spk * spk,) + tail)
    return metric_func(flat_e, flat_t, **kwargs).reshape(batch, spk, spk)


def _best_perm_exhaustive(metric_mtx: torch.Tensor, maximize: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    spk = metric_mtx.shape[-1]
    perms = _perm_table(spk, metric_mtx.device)  # [P, spk]
    # score[b, p] = mean_t mtx[b, t, perms[p, t]]
    targets = torch.arange(spk, device=metric_mtx.device)[None, :]
    scores = torch.mean(metric_mtx[:, targets, perms], dim=-1)  # [batch, P]
    best_idx = torch.argmax(scores, dim=-1) if maximize else torch.argmin(scores, dim=-1)
    best_metric = torch.gather(scores, -1, best_idx[:, None])[:, 0]
    return best_metric, perms[best_idx]


def _best_perm_hungarian(metric_mtx: torch.Tensor, maximize: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear-sum assignment of each sample on the host (large speaker counts)."""
    from scipy.optimize import linear_sum_assignment

    host = metric_mtx.detach().cpu().double().numpy()  # the one device-to-host copy
    best_perm = np.stack([linear_sum_assignment(m, maximize=maximize)[1] for m in host])
    best_perm = torch.as_tensor(best_perm, dtype=torch.int64, device=metric_mtx.device)
    best_metric = torch.mean(torch.gather(metric_mtx, -1, best_perm[:, :, None])[..., 0], dim=-1)
    return best_metric, best_perm


def pit(
    preds: torch.Tensor, target: torch.Tensor, metric_func: Callable, eval_func: str = "max", **kwargs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permutation-invariant evaluation of a pairwise metric.

    Args:
        preds: estimates, shape ``[batch, spk, ...]``
        target: references, shape ``[batch, spk, ...]``
        metric_func: batched pairwise metric: ``metric_func(preds, target) -> [batch]``
        eval_func: ``'max'`` (larger is better) or ``'min'``
        kwargs: extra args forwarded to ``metric_func``

    Returns:
        ``(best_metric [batch], best_perm [batch, spk])`` where
        ``best_perm[b, t]`` is the estimate index matched to target ``t``
        (int64, on the inputs' device).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio import si_sdr
        >>> preds = torch.tensor([[[-0.0579, 0.3560, -0.9604], [-0.1719, 0.3205, 0.2951]]])
        >>> target = torch.tensor([[[1.0958, -0.1648, 0.5228], [-0.4100, 1.1942, -0.5103]]])
        >>> best_metric, best_perm = pit(preds, target, si_sdr, 'max')
        >>> best_perm.tolist()
        [[0, 1]]
    """
    _check_same_shape(preds, target)
    if eval_func not in ("max", "min"):
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )
    metric_mtx = _metric_matrix(preds, target, metric_func, **kwargs)
    maximize = eval_func == "max"
    if target.shape[1] <= _MAX_EXHAUSTIVE_SPK:
        return _best_perm_exhaustive(metric_mtx, maximize)
    return _best_perm_hungarian(metric_mtx, maximize)


def pit_permutate(preds: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder ``preds``' speaker axis by the permutation from :func:`pit`.

    Args:
        preds: shape ``[batch, spk, ...]``
        perm: shape ``[batch, spk]``

    Returns:
        permuted estimates, same shape as ``preds``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pit, pit_permutate, si_sdr
        >>> preds = torch.tensor([[[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]])
        >>> target = torch.tensor([[[3.1, 3.9, 5.2], [0.2, 0.9, 2.1]]])
        >>> best_metric, best_perm = pit(preds, target, si_sdr, eval_func="max")
        >>> pit_permutate(preds, best_perm)[0, 0].tolist()
        [3.0, 4.0, 5.0]
    """
    if perm.is_floating_point():
        raise TypeError(f"take_along_axis indices must be of integer type, got {perm.dtype}")
    index = perm.to(torch.int64).reshape(tuple(perm.shape) + (1,) * (preds.ndim - 2))
    # a negative index counts from the end, as ``jnp.take_along_axis`` takes it
    index = torch.where(index < 0, index + preds.shape[1], index)
    return torch.gather(preds, 1, index.expand(preds.shape))
