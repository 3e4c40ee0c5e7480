"""Padding-aware ranking statistics: AUROC and average precision by sorting.

Counterpart of ``metrics_tpu/ops/ranking.py``. AUROC is the Mann–Whitney U
statistic with tie-averaged ranks,

    AUROC = (Σ ranks(positives) − P(P+1)/2) / (P·N),

which equals the trapezoidal ROC area, ties included; average precision is
the step integral ``Σ (R_k − R_{k−1})·P_k`` over distinct descending scores,
each tie group counted once at its last row. A ``mask`` leaves rows out (the
unfilled tail of a :class:`~metrics_tpu_torch.core.cat_buffer.CatBuffer`)
without slicing them away.

How the port computes them, and where it differs from the JAX package:

- **Sorting.** ``jnp.lexsort((values, key))`` becomes two stable sorts: the
  values first, then the validity key with ``stable=True``, which keeps the
  value order inside each key. Descending order sorts ``-values`` ascending,
  so NaN scores come last, as ``jnp.argsort(-x)`` puts them.
- **Ties without float atomics.** The JAX package averages the positions of
  a tie group with ``segment_sum`` in float32; on CUDA the counterpart
  (``index_add_``) is float atomics in no fixed order. Here the rows are
  sorted, a group is a run of equal values, and its average rank is
  ``(first + last position) / 2``: group ids are a running sum of the group
  starts, each start writes its position into its id's slot, and each row
  reads its own and the next group's start back (``_group_bounds``). Twice the
  rank is an integer, so the rank sum of the positives is an exact int64,
  and AUROC is ``(S2 − P(P+1)) / (2·P·N)`` in float64, cast to float32:
  deterministic and the same on the CPU and the card. It differs from the
  JAX value only by the JAX package's float32 rounding (its rank sum of
  about N²/4 is rounded; about 1e-7 relative at the tests' sizes).
- **Average precision.** The cumulative true and false positives are int32
  running sums (exact); precision is their float32 quotient, as in the JAX
  package, and each group's positive count is its running sum less the
  running sum before the group's first row (no segment sum). The sum of
  the terms is float64, then cast to float32.
- **Classes at once.** ``vmap(..., in_axes=(1, 1))`` over the classes becomes
  one computation over ``[C, N]`` rows, each sorted along the last
  dimension; no Python loop over classes. At ``C = 1000``, ``N = 49152``
  one ``[C, N]`` float32 or int32 tensor is 197 MB and one int64 tensor
  393 MB; the helpers drop each one as soon as it is used.
"""
from typing import Optional, Tuple

import torch

__all__ = [
    "masked_binary_auroc",
    "masked_binary_average_precision",
    "masked_multiclass_auroc",
    "masked_multiclass_average_precision",
    "masked_multilabel_auroc",
    "tie_averaged_ranks",
]


def _sorted_rows(
    values: torch.Tensor, valid: Optional[torch.Tensor], descending: bool
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Sort each row of ``values`` ``[R, N]`` by value, stably; with a row mask
    ``valid`` ``[N]``, invalid rows go first (ascending) or last
    (descending). Returns the permutation ``[R, N]`` (int64), the sorted
    values and, with a mask, the sorted validity."""
    if descending:
        v_sorted, order = torch.sort(-values, dim=-1, stable=True)
        v_sorted = v_sorted.neg_()
    else:
        v_sorted, order = torch.sort(values, dim=-1, stable=True)
    if valid is None:
        return order, v_sorted, None
    valid_g = valid[order]
    key = (valid_g if not descending else ~valid_g).to(torch.uint8)
    perm = torch.sort(key, dim=-1, stable=True).indices
    del key
    return order.gather(-1, perm), v_sorted.gather(-1, perm), valid_g.gather(-1, perm)


def _group_breaks(v_sorted: torch.Tensor, valid_sorted: Optional[torch.Tensor]) -> torch.Tensor:
    """``[R, N - 1]`` bool: row k + 1 starts a new tie group. A change of
    validity always starts one, so equal values never tie across the mask."""
    breaks = v_sorted[..., 1:] != v_sorted[..., :-1]
    if valid_sorted is not None:
        breaks |= valid_sorted[..., 1:] != valid_sorted[..., :-1]
    return breaks


def _group_bounds(breaks: torch.Tensor, with_last: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """First and last sorted position (int32) of the tie group of each row
    position, from the group breaks ``[R, N - 1]``. Group ids are a running
    sum of the group starts; each start writes its position at its group's
    id (the other rows write to a spare column), and every row reads its
    group's start and the next group's start back. Running sums, a scatter
    to distinct slots and two gathers, all deterministic and parallel along
    a row (a running maximum, ``cummax``, runs a long row on one block)."""
    rows, n = breaks.shape[0], breaks.shape[-1] + 1
    start = torch.cat([torch.ones((rows, 1), dtype=torch.bool, device=breaks.device), breaks], -1)
    gid = start.cumsum(-1).sub_(1)
    starts = torch.full((rows, n + 2), n, dtype=torch.int32, device=breaks.device)
    pos = torch.arange(n, dtype=torch.int32, device=breaks.device).expand(rows, n)
    starts.scatter_(-1, torch.where(start, gid, torch.full_like(gid, n + 1)), pos)
    del start
    first = starts.gather(-1, gid)
    last = starts.gather(-1, gid.add_(1)).sub_(1) if with_last else None
    return first, last


def _twice_ranks_sorted(v_sorted: torch.Tensor, valid_sorted: Optional[torch.Tensor]) -> torch.Tensor:
    """Twice the 1-based tie-averaged rank among valid rows, at each sorted
    position, as int32 (invalid rows, sorted first, get meaningless values)."""
    first, last = _group_bounds(_group_breaks(v_sorted, valid_sorted))
    twice = first.add_(last).add_(2)
    if valid_sorted is not None:
        n_invalid = (~valid_sorted).sum(-1, keepdim=True, dtype=torch.int32)
        twice.sub_(2 * n_invalid)
    return twice


def tie_averaged_ranks(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """1-based tie-averaged ranks of ``values`` ``[N]`` among the rows where
    ``valid``; invalid rows get 0, as in the JAX package."""
    values = torch.as_tensor(values)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=values.device).reshape(-1)
    order, v_sorted, valid_sorted = _sorted_rows(values.reshape(1, -1), valid, descending=False)
    twice = _twice_ranks_sorted(v_sorted, valid_sorted)
    dtype = values.dtype if values.is_floating_point() else torch.float32
    rank_sorted = torch.where(valid_sorted, twice.to(dtype) / 2, torch.zeros((), dtype=dtype, device=values.device))
    return torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted).reshape(-1)


def _auroc_rows(scores: torch.Tensor, positive: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mann–Whitney AUROC of each row of ``scores`` ``[R, N]`` (float32), with
    ``positive(order)`` giving the ``[R, N]`` bool labels in sorted order;
    0.5 where a row has no valid positive or no valid negative."""
    order, v_sorted, valid_sorted = _sorted_rows(scores, valid, descending=False)
    pos_sorted = positive(order)
    del order
    if valid_sorted is not None:
        pos_sorted &= valid_sorted
    twice = _twice_ranks_sorted(v_sorted, valid_sorted)
    del v_sorted
    s2 = torch.where(pos_sorted, twice, torch.zeros((), dtype=torch.int32, device=twice.device)).sum(-1)
    del twice
    n_pos = pos_sorted.sum(-1)
    n_valid = scores.shape[-1] if valid is None else valid.sum()
    n_neg = n_valid - n_pos
    denom = n_pos * n_neg
    u2 = s2 - n_pos * (n_pos + 1)
    auroc = u2.double() / (2 * denom.clamp_min(1)).double()
    return torch.where(denom > 0, auroc, torch.full_like(auroc, 0.5)).to(torch.float32)


def _average_precision_rows(
    scores: torch.Tensor, positive: torch.Tensor, valid: Optional[torch.Tensor]
) -> torch.Tensor:
    """Step-integral average precision of each row of ``scores`` ``[R, N]``;
    NaN where a row has no valid positive (0/0, as the curve gives)."""
    order, v_sorted, valid_sorted = _sorted_rows(scores, valid, descending=True)
    t = positive(order)
    del order
    rows, n = t.shape
    if valid_sorted is not None:
        t &= valid_sorted
        seen = valid_sorted.cumsum(-1, dtype=torch.int32)
    else:
        seen = torch.arange(1, n + 1, dtype=torch.int32, device=t.device).expand(rows, n)
    tps = t.cumsum(-1, dtype=torch.int32)
    n_pos = tps[..., -1].to(torch.float64) if n else torch.zeros(rows, dtype=torch.float64, device=t.device)
    precision = tps.to(torch.float32) / seen.clamp_min(1).to(torch.float32)
    del seen
    breaks = _group_breaks(v_sorted, valid_sorted)
    del v_sorted
    # true positives before each row's tie group: the exclusive running sum
    # at the group's first row
    first, _ = _group_bounds(breaks, with_last=False)
    before = (tps - t.to(torch.int32)).gather(-1, first.long())
    del first
    # last row of each tie group among the valid rows
    if valid_sorted is not None:
        breaks |= ~valid_sorted[..., 1:]
    end = torch.cat([breaks, torch.ones((rows, 1), dtype=torch.bool, device=t.device)], -1)
    del breaks
    if valid_sorted is not None:
        end &= valid_sorted
    zero = torch.zeros((), dtype=torch.int32, device=t.device)
    group_pos = torch.where(end, tps - before, zero)
    contrib = group_pos.to(torch.float32) * precision
    return (contrib.to(torch.float64).sum(-1) / n_pos).to(torch.float32)


def _valid_rows(mask: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
    return None if mask is None else torch.as_tensor(mask, device=device).to(torch.bool).reshape(-1)


def masked_binary_average_precision(
    preds: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Exact binary average precision over the rows where ``mask``.

    Each tied score group contributes once, at its cumulative counts
    (sklearn's and the curve path's semantics). NaN when no valid positive
    exists, as ``0/0`` on the curve.
    """
    preds = torch.as_tensor(preds).to(torch.float32).reshape(1, -1)
    target = torch.as_tensor(target, device=preds.device).reshape(-1) != 0
    valid = _valid_rows(mask, preds.device)
    return _average_precision_rows(preds, lambda order: target[order], valid)[0]


def masked_binary_auroc(preds: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact binary AUROC over the rows where ``mask``.

    Args:
        preds: ``[N]`` scores.
        target: ``[N]`` binary labels (0/1).
        mask: ``[N]`` bool validity; ``None`` = all valid.

    Returns 0.5 when either class is absent among the valid rows.
    """
    preds = torch.as_tensor(preds).to(torch.float32).reshape(1, -1)
    target = torch.as_tensor(target, device=preds.device).reshape(-1) != 0
    valid = _valid_rows(mask, preds.device)
    return _auroc_rows(preds, lambda order: target[order], valid)[0]


def _average_per_class(
    per_class: torch.Tensor, support: torch.Tensor, average: Optional[str], nan_ignoring: bool = False
) -> torch.Tensor:
    """Reduce ``[C]`` per-class scores as the curve paths do: ``weighted``
    weights by support, so unobserved classes drop out; with
    ``nan_ignoring`` (average precision) NaN classes leave the mean."""
    if average in (None, "none"):
        return per_class
    if nan_ignoring:
        ok = ~torch.isnan(per_class)
        safe = torch.where(ok, per_class, torch.zeros_like(per_class))
    else:
        ok = torch.ones(per_class.shape, dtype=torch.bool, device=per_class.device)
        safe = per_class
    okf = ok.to(per_class.dtype)
    if average == "macro":
        return torch.sum(safe * okf) / torch.clamp_min(torch.sum(okf), 1.0)
    if average == "weighted":
        w = support.to(per_class.dtype) * okf
        return torch.sum(safe * w) / torch.clamp_min(torch.sum(w), 1.0)
    raise ValueError(f"Unsupported average {average!r} for the masked ranking path")


def _one_vs_rest(preds: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor]):
    """Class-major scores ``[C, N]``, the sorted-label function of one-vs-rest
    labels for integer targets ``[N]``, the class supports among the valid
    rows, and the row mask."""
    preds = torch.as_tensor(preds).to(torch.float32)
    n, num_classes = preds.shape
    labels = torch.as_tensor(target, device=preds.device).reshape(-1).to(torch.int32)
    classes = torch.arange(num_classes, dtype=torch.int32, device=preds.device).unsqueeze(-1)
    valid = _valid_rows(mask, preds.device)
    counted = labels if valid is None else torch.where(valid, labels, torch.full_like(labels, -1))
    support = (counted.unsqueeze(0) == classes).sum(-1).to(torch.float32)
    return preds.t(), (lambda order: labels[order] == classes), support, valid


def _multilabel(preds: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor]):
    """Class-major scores and binary labels ``[C, N]``, the sorted-label
    function, the supports among the valid rows, and the row mask."""
    preds = torch.as_tensor(preds).to(torch.float32)
    labels = torch.as_tensor(target, device=preds.device).t() != 0
    valid = _valid_rows(mask, preds.device)
    support = (labels if valid is None else labels & valid).sum(-1).to(torch.float32)
    return preds.t(), (lambda order: labels.gather(-1, order)), support, valid


def masked_multiclass_auroc(
    preds: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None, average: Optional[str] = "macro"
) -> torch.Tensor:
    """One-vs-rest AUROC over ``[N, C]`` scores and integer targets ``[N]``,
    all classes in one batched computation. A class absent among the valid
    rows scores 0.5; under ``weighted`` its zero support drops it."""
    scores, positive, support, valid = _one_vs_rest(preds, target, mask)
    return _average_per_class(_auroc_rows(scores, positive, valid), support, average)


def masked_multilabel_auroc(
    preds: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None, average: Optional[str] = "macro"
) -> torch.Tensor:
    """Per-label AUROC over ``[N, C]`` scores and ``[N, C]`` binary targets;
    ``micro`` pools every (row, label) decision into one binary problem."""
    if average == "micro":
        preds = torch.as_tensor(preds)
        n, num_classes = preds.shape
        flat_mask = None
        if mask is not None:
            flat_mask = _valid_rows(mask, preds.device).unsqueeze(-1).expand(n, num_classes).reshape(-1)
        return masked_binary_auroc(preds.reshape(-1), torch.as_tensor(target).reshape(-1), flat_mask)
    scores, positive, support, valid = _multilabel(preds, target, mask)
    return _average_per_class(_auroc_rows(scores, positive, valid), support, average)


def masked_multiclass_average_precision(
    preds: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None, average: Optional[str] = "macro"
) -> torch.Tensor:
    """One-vs-rest average precision over ``[N, C]`` scores and integer
    targets ``[N]``. Classes without a valid positive are NaN and leave the
    ``macro``/``weighted`` averages, as on the curve path; ``weighted``
    normalizes the weights over all classes, as the curve path does."""
    scores, positive, support, valid = _one_vs_rest(preds, target, mask)
    per_class = _average_precision_rows(scores, positive, valid)
    if average == "weighted":
        w = support / torch.clamp_min(torch.sum(support), 1.0)
        ok = ~torch.isnan(per_class)
        return torch.sum(torch.where(ok, per_class * w, torch.zeros_like(per_class)))
    return _average_per_class(per_class, support, average, nan_ignoring=True)
