"""Sorted segment ops for ragged query groups.

Counterpart of ``metrics_tpu/ops/segment.py``: rows are sorted by (query id,
score descending), after which every per-query retrieval statistic is a
reduction over a contiguous segment of rows, one pass over all queries.

How the port computes them, and where it differs from the JAX package:

- **Sort order.** ``jnp.lexsort((-preds, indexes))`` is two stable sorts,
  here ``torch.sort(stable=True)`` on the descending score key and then on
  the query ids. Equal scores keep their input order. The JAX sort treats
  -0.0 as 0.0 and every NaN as one value above all numbers; the key here
  does the same explicitly (``descending_key``), so a radix sort on the card
  cannot order them by their bits.
- **Group bounds without scatters.** The group ids are non-decreasing after
  the sort, so each group's first row and size come from two
  ``searchsorted`` calls over the group ids, exact and with no atomics. An
  empty group (a ``num_groups`` bound above the data) has size 0 and the
  start ``2**31 - 1``, the value ``jax.ops.segment_min`` gives it.
- **Out-of-range group ids.** The JAX ``segment_*`` ops drop the rows whose
  id is ``num_groups`` (the padding of ``valid`` mode) and clamp the gathers
  that read them. Torch's scatters and gathers raise on such ids (a device
  assert on the card), so they are masked or clamped here explicitly.
- **No float atomics.** A float segment sum is ``torch.segment_reduce`` over
  the sorted rows with the group sizes as lengths (the padding rows form one
  trailing segment that is dropped): each segment is reduced on its own, in
  an order fixed by its length and place, never by ``index_add_``'s float
  atomics, so list mode and capacity mode give the same bits. Integer sums
  are exact differences of an int64 running sum, read at the group bounds,
  and a segment minimum is an integer (or float) ``scatter_reduce`` of
  ``amin``, which commutes.
"""
from typing import NamedTuple, Optional, Tuple

import torch

#: ``jax.ops.segment_min``'s value for an empty int32 segment, kept as the
#: start of an empty group.
_EMPTY_START = 2**31 - 1


class GroupedByQuery(NamedTuple):
    """Flat rows sorted by (query, score desc) with segment bookkeeping."""

    preds: torch.Tensor        # [N] scores, sorted
    target: torch.Tensor       # [N] relevance, aligned
    gid: torch.Tensor          # [N] 0-based dense group id, non-decreasing (int64)
    rank: torch.Tensor         # [N] 1-based rank within the group (by score desc)
    num_groups: int            # number of groups
    group_sizes: torch.Tensor  # [G]
    group_start: torch.Tensor  # [G] position of each group's first row
    lengths: torch.Tensor      # [G + 1] group sizes, then the rows outside every group


def descending_key(values: torch.Tensor) -> torch.Tensor:
    """``-values`` as an ascending sort key that orders like the JAX sort:
    -0.0 equal to 0.0 and every NaN one value, last."""
    if not values.is_floating_point():
        return -values
    key = -values + 0.0  # -0.0 + 0.0 is +0.0
    return torch.where(torch.isnan(key), torch.full_like(key, float("nan")), key)


def _lexsort(primary: torch.Tensor, secondary_key: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((secondary_key, primary))``: the order that sorts by
    ``primary`` and, within equal ``primary``, by ``secondary_key``, stably."""
    order = torch.sort(secondary_key, stable=True).indices
    return order[torch.sort(primary[order], stable=True).indices]


def group_by_query(
    indexes: torch.Tensor,
    preds: torch.Tensor,
    target: torch.Tensor,
    num_groups: Optional[int] = None,
    valid: Optional[torch.Tensor] = None,
) -> GroupedByQuery:
    """Sort rows by (query id asc, score desc) and build segment metadata.

    ``num_groups`` is an upper bound on the distinct query ids; without it
    the count is read from the data (one host read).

    ``valid`` (with ``num_groups``) is the padded mode of fixed-capacity
    CatBuffer states: invalid rows take the sentinel query id
    ``iinfo(dtype).max`` so they sort to the very end, and their group id is
    set to ``num_groups``, outside every group. Group sizes, starts, ranks
    and reductions count valid rows only. A valid row carrying the sentinel
    id raises ``ValueError``, as in the JAX package.
    """
    if valid is not None:
        if num_groups is None:
            raise ValueError("`valid` masking needs a static `num_groups` bound")
        sentinel = torch.iinfo(indexes.dtype).max
        # the padding sort key is reserved: a valid row with that id would
        # sort among the padding (one host read, as the JAX package's check)
        if bool(torch.any(valid & (indexes == sentinel))):
            raise ValueError(
                f"query id {sentinel} (iinfo({str(indexes.dtype).replace('torch.', '')}).max) is "
                "reserved as the padding sentinel in `valid` mode; re-key the "
                "offending queries or use a wider index dtype."
            )
        indexes = torch.where(valid, indexes, torch.full_like(indexes, sentinel))
        preds_key = torch.where(valid, preds, torch.full_like(preds, float("-inf")))
    else:
        preds_key = preds
    order = _lexsort(indexes, descending_key(preds_key))
    idx_s = indexes[order]
    preds_s = preds[order]
    target_s = target[order]
    valid_s = valid[order] if valid is not None else None
    n = idx_s.shape[0]

    new_group = torch.ones(n, dtype=torch.bool, device=idx_s.device)
    new_group[1:] = idx_s[1:] != idx_s[:-1]
    gid = new_group.cumsum(0) - 1
    if valid_s is not None:
        # padding rows all share the sentinel id, one trailing pseudo-group:
        # route them outside every group
        gid = torch.where(valid_s, gid, torch.full_like(gid, num_groups))
    if num_groups is None:
        num_groups = int(gid[-1]) + 1 if n else 0
    elif n:
        # gids are DENSE 0-based group ids, so the bound constrains the
        # number of DISTINCT query ids, not their magnitude. Valid rows keep
        # their dense ids, so an overflow of the bound shows here; the
        # padding rows' out-of-range gid does not count
        in_range = gid if valid_s is None else torch.where(valid_s, gid, -1)
        actual = int(in_range.max()) + 1
        if actual > num_groups:
            raise ValueError(
                f"`num_queries={num_groups}` is a static upper bound on DISTINCT "
                f"query ids, but the data holds {actual} distinct ids; raise it."
            )

    groups = torch.arange(num_groups, device=gid.device)
    start = torch.searchsorted(gid, groups)
    group_sizes = torch.searchsorted(gid, groups, right=True) - start
    group_start = torch.where(group_sizes > 0, start, torch.full_like(start, _EMPTY_START))
    positions = torch.arange(n, device=gid.device)
    # padding rows read the last group's start: garbage ranks for padding
    # rows only, which no reduction reads (as the JAX package's clamp)
    rank = positions - group_start[gid.clamp(max=num_groups - 1)] + 1
    lengths = torch.cat([group_sizes, (n - group_sizes.sum()).reshape(1)])
    return GroupedByQuery(preds_s, target_s, gid, rank, num_groups, group_sizes, group_start, lengths)


def _segment_bounds(g: GroupedByQuery) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each group's ``[start, end)`` rows (an empty group is ``[end, end)``)."""
    end = g.lengths[:-1].cumsum(0)
    return end - g.group_sizes, end


def segment_sum(values: torch.Tensor, g: GroupedByQuery) -> torch.Tensor:
    """Per-group sums ``[G]``: floats by a segmented reduction of the sorted
    rows, integers and bools exactly (int64) from a running sum."""
    if values.is_floating_point():
        # unsafe=True: the lengths sum to N by construction; the check would
        # read them on the host
        return torch.segment_reduce(values, "sum", lengths=g.lengths, unsafe=True)[: g.num_groups]
    running = values.cumsum(0, dtype=torch.int64)
    start, end = _segment_bounds(g)
    # running sums at each group's last row and just before its first
    # (an empty group reads the same row twice: 0)
    last = torch.where(end > 0, running[(end - 1).clamp(min=0)], 0)
    before = torch.where(start > 0, running[(start - 1).clamp(min=0)], 0)
    return last - before


def segment_min(values: torch.Tensor, g: GroupedByQuery) -> torch.Tensor:
    """Per-group minima ``[G]``; an empty group gives the dtype's largest
    value (``+inf`` for floats), as ``jax.ops.segment_min``."""
    fill = float("inf") if values.is_floating_point() else torch.iinfo(values.dtype).max
    inside = g.gid < g.num_groups
    out = torch.full((g.num_groups,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(
        0, torch.where(inside, g.gid, 0), torch.where(inside, values, torch.full_like(values, fill)), "amin"
    )


def segment_cumsum(values: torch.Tensor, g: GroupedByQuery) -> torch.Tensor:
    """Within-group cumulative sum (inclusive) for sorted segments. Integer
    values sum exactly in int64."""
    prefix = values.cumsum(0) if values.is_floating_point() else values.cumsum(0, dtype=torch.int64)
    start = g.group_start
    # prefix value just before each group's first row (an empty group's
    # start is out of range: clamped, as the JAX gather clamps)
    gathered = prefix[(start - 1).clamp(0, max(prefix.shape[0] - 1, 0))]
    before = torch.where(start > 0, gathered, torch.zeros_like(gathered))
    return prefix - before[g.gid.clamp(max=g.num_groups - 1)]


def relevance_sorted(g: GroupedByQuery) -> Tuple[torch.Tensor, torch.Tensor]:
    """(target, rank) with rows re-sorted by relevance desc within each group
    (gid is unchanged by a within-group permutation): the 'ideal' ordering
    used for IDCG."""
    order = _lexsort(g.gid, descending_key(g.target))
    positions = torch.arange(g.gid.shape[0], device=g.gid.device)
    rank_sorted = positions - g.group_start[g.gid.clamp(max=g.num_groups - 1)] + 1
    return g.target[order], rank_sorted
