"""On-device linear algebra for the image metrics.

Counterpart of ``metrics_tpu/ops/linalg.py``: Kahan-compensated sums for
float32 streaming moments, and ``trace(sqrtm(S1 @ S2))`` by ``eigh`` or by a
monitored Newton–Schulz iteration, all on the tensors' own device (on the
card ``torch.linalg.eigh`` is cuSOLVER's and the products cuBLAS's): no
copy to the host and no scipy.
"""
from typing import Tuple

import torch

_METHODS = ("auto", "eigh", "ns")


def kahan_merge(
    a_total: torch.Tensor, a_comp: torch.Tensor, b_total: torch.Tensor, b_comp: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two Kahan accumulator pairs into one, keeping the rescue.

    Two-sum captures the roundoff ``e`` of ``a_total + b_total`` exactly, so
    ``total - comp == (a_total - a_comp) + (b_total - b_comp)`` to full
    compensated precision (forward's accumulation, checkpoint folds).
    """
    t = a_total + b_total
    bv = t - a_total
    av = t - bv
    e = (a_total - av) + (b_total - bv)  # exact: a + b == t + e
    return t, a_comp + b_comp - e


def kahan_add(total: torch.Tensor, comp: torch.Tensor, value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Kahan-compensated accumulation step: ``(total', comp')``. The
    compensation carries the roundoff lost by ``total + value``; both terms
    are plain "sum" states, so a cross-process sum composes."""
    y = value - comp
    t = total + y
    return t, (t - total) - y


def sqrtm_newton_schulz(mat: torch.Tensor, num_iters: int = 25) -> torch.Tensor:
    """Square root of a symmetric PSD matrix by Newton–Schulz, pre-scaled by
    its Frobenius norm (the iteration converges for ``||I - A/||A|| || < 1``)
    and rescaled by its square root, in the input's dtype."""
    dim = mat.shape[-1]
    norm = torch.linalg.norm(mat)
    eye = torch.eye(dim, dtype=mat.dtype, device=mat.device)
    y, z = mat / norm, eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def trace_sqrtm_product_eigh(sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """``trace(sqrtm(sigma1 @ sigma2))`` for symmetric PSD inputs by two
    ``eigh``: ``sigma1 @ sigma2`` is similar to the PSD ``A1 @ sigma2 @ A1``
    with ``A1 = sqrtm(sigma1)``, so the trace is the sum of the square roots
    of that matrix's eigenvalues."""
    vals1, vecs1 = torch.linalg.eigh(sigma1)
    sqrt1 = (vecs1 * torch.sqrt(torch.clamp(vals1, min=0.0))) @ vecs1.T
    inner = sqrt1 @ sigma2 @ sqrt1
    eigs = torch.linalg.eigvalsh(inner)
    return torch.sum(torch.sqrt(torch.clamp(eigs, min=0.0)))


def trace_sqrtm_product_ns(sigma1: torch.Tensor, sigma2: torch.Tensor, max_iters: int = 40) -> torch.Tensor:
    """``trace(sqrtm(sigma1 @ sigma2))`` by monitored Newton–Schulz: matmuls
    only, no host read. In float32 the iteration converges, then diverges
    from roundoff on ill-conditioned or rank-deficient inputs, while the trace
    plateaus at the true value first; so the iterate with the smallest
    ``|Δtrace|`` between consecutive steps is returned. The strict ``<``
    keeps it once the iterates turn NaN, and a zero product gives 0."""
    a = sigma1 @ sigma2
    dim = a.shape[-1]
    dtype, device = a.dtype, a.device
    norm = torch.linalg.norm(a)
    eye = torch.eye(dim, dtype=dtype, device=device)
    # zero (or fully underflowed) product: sqrtm is the zero matrix; guard
    # the normalization so the iteration cannot make NaNs
    safe_norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    y, z = a / safe_norm, eye
    prev_tr = best_tr = torch.trace(y)
    best_dt = torch.full((), torch.finfo(dtype).max, dtype=dtype, device=device)
    for _ in range(max_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
        tr = torch.trace(y)
        dt = torch.abs(tr - prev_tr)
        better = dt < best_dt
        best_tr = torch.where(better, tr, best_tr)
        best_dt = torch.where(better, dt, best_dt)
        prev_tr = tr
    return torch.where(norm > 0, best_tr * torch.sqrt(safe_norm), torch.zeros((), dtype=dtype, device=device))


def check_sqrtm_method(method: str) -> str:
    if method not in _METHODS:
        raise ValueError(f"unknown sqrtm method {method!r}; use 'auto', 'eigh' or 'ns'")
    return method


def trace_sqrtm_product(sigma1: torch.Tensor, sigma2: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """``trace(sqrtm(sigma1 @ sigma2))``. ``"auto"`` is ``"eigh"`` here: the
    JAX package picks Newton–Schulz only on a TPU, where ``eigh`` compiles
    slowly. ``"eigh"``/``"ns"`` force a path."""
    if check_sqrtm_method(method) == "ns":
        return trace_sqrtm_product_ns(sigma1, sigma2)
    return trace_sqrtm_product_eigh(sigma1, sigma2)
