"""Bucketed host sync: one collective per dtype/reduction class, not per leaf.

Counterpart of the flat (untiered) path of ``metrics_tpu/parallel/bucketing.py``.
Given a state dict, or the key-prefixed combined states of a whole
``MetricCollection``, the planner classifies every leaf into a
:class:`SyncPlan`:

- **reduce leaves** (``fx`` in ``sum``/``mean``/``max``/``min``) group by
  ``(dtype, fx)``: each bucket flattens into one buffer, gathers once to
  ``[world, total]``, reduces over the world axis and splits back. The
  reduction runs over the same ``world`` values as the per-leaf path, so the
  results are the same bits;
- **cat-family leaves** (CatBuffer, list states, tensors with ``fx`` in
  ``("cat", None)``) group by dtype into one padded ragged buffer, sized from
  the health header's length columns (no shape gathers); every rank slices
  each leaf's per-rank rows back out;
- **callable-``fx`` leaves** keep the per-leaf path.

The plan is cached in the one schema-keyed store of ``core/plan.py``
(:func:`build_sync_plan` is a view over ``plan_for(...).sync_layout``), so
repeated syncs of one schema plan once, whichever thread syncs. A flat buffer is packed on the
state's device, crosses the collective on the process group's collective
device (``sync._gather``: the card under NCCL, the host under gloo) and comes
back to the state's device.

The caller must have verified the gathered health words first:
``host_sync_state`` does, and is the entry point. ``METRICS_TPU_FUSED_SYNC=0``
restores the per-leaf path.
"""
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.parallel.health import (
    cat_family_names,
    cat_row_count,
    header_cat_lengths,
)
from metrics_tpu_torch.parallel.sync import _sum_keep_dtype

__all__ = [
    "LeafSpec",
    "SyncPlan",
    "build_sync_plan",
    "clear_sync_plan_cache",
    "fused_sync_enabled",
    "host_sync_state_bucketed",
    "sync_plan_cache_info",
]

#: Env escape hatch: 0/false/off/no restores the per-leaf payload path.
FUSED_SYNC_ENV = "METRICS_TPU_FUSED_SYNC"


def _mean(g: torch.Tensor) -> torch.Tensor:
    return torch.mean(g if g.is_floating_point() else g.to(torch.float32), dim=0)


_REDUCERS = {
    "sum": _sum_keep_dtype,
    "mean": _mean,
    "max": lambda g: torch.amax(g, dim=0),
    "min": lambda g: torch.amin(g, dim=0),
}


def fused_sync_enabled() -> bool:
    """The default payload path: bucketed, unless the env knob opts out."""
    return os.environ.get(FUSED_SYNC_ENV, "1").strip().lower() not in ("0", "false", "off", "no")


class LeafSpec:
    """One leaf's place in the plan.

    ``kind`` is ``reduce`` | ``cat`` | ``list`` | ``catbuf`` | ``fallback``.
    ``item_shape``/``item_size`` describe one row of a cat-family leaf and
    the whole (rank-invariant) tensor of a reduce leaf. ``cat_index`` is the
    leaf's column in the header's length table (-1 for other kinds).
    """

    __slots__ = ("name", "kind", "fx", "dtype", "item_shape", "item_size", "cat_index")

    def __init__(self, name: str, kind: str, fx: Any, dtype: Optional[torch.dtype],
                 item_shape: Tuple[int, ...], cat_index: int = -1) -> None:
        self.name = name
        self.kind = kind
        self.fx = fx
        self.dtype = dtype
        self.item_shape = item_shape
        self.item_size = int(np.prod(item_shape, dtype=np.int64)) if item_shape else 1
        self.cat_index = cat_index


class SyncPlan:
    """Which leaves ride which collective, for one schema (``schema_key``)."""

    __slots__ = ("cat_leaves", "reduce_buckets", "cat_buckets", "fallback", "schema_key")

    def __init__(self, cat_leaves: List[LeafSpec], reduce_buckets: Dict[Tuple[str, Any], List[LeafSpec]],
                 cat_buckets: Dict[str, List[LeafSpec]], fallback: List[LeafSpec], schema_key: str = "") -> None:
        self.cat_leaves = cat_leaves
        self.reduce_buckets = reduce_buckets
        self.cat_buckets = cat_buckets
        self.fallback = fallback
        self.schema_key = schema_key

    @property
    def n_buckets(self) -> int:
        return len(self.reduce_buckets) + len(self.cat_buckets)


# The layouts are cached in the one schema-keyed store of ``core/plan.py``
# (one ExecutionPlan per schema); these two names stay as views over it.


def clear_sync_plan_cache() -> None:
    """Empty the plan store and zero its counters (``core.plan.clear_plans``)."""
    from metrics_tpu_torch.core.plan import clear_plans

    clear_plans()


def sync_plan_cache_info() -> Dict[str, int]:
    """``{"size", "hits", "misses"}`` of the plan store."""
    from metrics_tpu_torch.core.plan import plan_cache_info

    info = plan_cache_info()
    return {"size": info["size"], "hits": info["hits"], "misses": info["misses"]}


def _classify(state: Dict[str, Any], reductions: Dict[str, Any], schema_key: str = "") -> SyncPlan:
    cat_order = {n: j for j, n in enumerate(cat_family_names(state, reductions))}
    cat_leaves: List[LeafSpec] = []
    reduce_buckets: Dict[Tuple[str, Any], List[LeafSpec]] = {}
    cat_buckets: Dict[str, List[LeafSpec]] = {}
    fallback: List[LeafSpec] = []
    for name in sorted(state):
        v = state[name]
        fx = reductions.get(name)
        if isinstance(v, CatBuffer):
            item = () if v.buffer is None else tuple(v.buffer.shape[1:])
            dtype = None if v.buffer is None else v.buffer.dtype
            spec = LeafSpec(name, "catbuf", fx, dtype, item, cat_order[name])
        elif isinstance(v, (list, tuple)):
            if len(v):
                first = torch.as_tensor(v[0])
                spec = LeafSpec(name, "list", fx, first.dtype, tuple(first.shape[1:]), cat_order[name])
            else:
                spec = LeafSpec(name, "list", fx, None, (), cat_order[name])
        else:
            arr = torch.as_tensor(v)
            if fx in ("cat", None):
                spec = LeafSpec(name, "cat", fx, arr.dtype, tuple(arr.shape[1:]), cat_order[name])
            elif fx in _REDUCERS:
                spec = LeafSpec(name, "reduce", fx, arr.dtype, tuple(arr.shape))
            else:
                # a callable reduces the [world, ...] stack opaquely: it
                # cannot share a buffer and keeps the per-leaf path
                spec = LeafSpec(name, "fallback", fx, arr.dtype, tuple(arr.shape))
        if spec.kind == "reduce":
            reduce_buckets.setdefault((str(spec.dtype), spec.fx), []).append(spec)
        elif spec.kind == "fallback":
            fallback.append(spec)
        else:
            cat_leaves.append(spec)
            if spec.dtype is not None:
                cat_buckets.setdefault(str(spec.dtype), []).append(spec)
            else:
                # item spec unknown (an empty state): a passed health check
                # excludes it (its count column is 0), so this is defensive
                fallback.append(spec)
    return SyncPlan(cat_leaves, reduce_buckets, cat_buckets, fallback, schema_key)


def build_sync_plan(state: Dict[str, Any], reductions: Dict[str, Any]) -> SyncPlan:
    """The cached layout of this state's schema: a view into the
    :class:`~metrics_tpu_torch.core.plan.ExecutionPlan` store, keyed on the
    exact schema string the health word hashes (callable reductions all tag
    as ``"callable"``: their leaves keep the per-leaf path, which reads each
    call's own reduction)."""
    from metrics_tpu_torch.core.plan import plan_for

    return plan_for(state, reductions).sync_layout


def _local_flat_rows(value: Any) -> torch.Tensor:
    """This rank's rows of a cat-family leaf, flattened to 1-D."""
    if isinstance(value, CatBuffer):
        return value.values().reshape(-1)
    if isinstance(value, (list, tuple)):
        return torch.cat([torch.as_tensor(x).reshape(1) if torch.as_tensor(x).ndim == 0 else torch.as_tensor(x)
                          for x in value]).reshape(-1)
    return torch.as_tensor(value).reshape(-1)


def _assemble_cat(spec: LeafSpec, pieces: List[torch.Tensor], local_value: Any, world: int) -> Any:
    """One cat-family leaf rebuilt from its per-rank rows, as
    ``host_sync_leaf`` builds it from its own gather."""
    if spec.kind == "catbuf":
        merged = CatBuffer(world * local_value.capacity)
        for p in pieces:
            merged.append(p)
        return merged
    if spec.kind == "list":
        return list(pieces)
    return torch.cat(pieces)


def host_sync_state_bucketed(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    words: Optional[np.ndarray] = None,
    group: Optional[Any] = None,
    timeout: Optional[float] = None,
) -> Dict[str, Any]:
    """Bucketed payload sync of a whole (possibly collection-combined) state.

    The caller verified the gathered health ``words``: the plan assumes equal
    schemas, non-empty cat states and clean CatBuffers. Issues one collective
    per reduce bucket and per cat bucket, the per-leaf cost of callable-``fx``
    leaves, and one length-vector gather only past ``CAT_LENGTH_SLOTS``
    cat-family states.
    """
    from metrics_tpu_torch.parallel import sync

    world = sync._world_size(group)
    plan = build_sync_plan(state, reductions)
    out: Dict[str, Any] = {}

    # per-rank row counts of every cat-family leaf: the only dynamic input
    n_cat = len(plan.cat_leaves)
    lengths: Optional[np.ndarray] = None
    if n_cat:
        if words is not None:
            lengths = header_cat_lengths(words, n_cat)
        if lengths is None:
            kinds = {"catbuf": "catbuf", "list": "list"}
            local = torch.tensor(
                [cat_row_count(state[s.name], kinds.get(s.kind, "leaf")) for s in plan.cat_leaves], dtype=torch.int32)
            lengths = torch.stack(sync._gather(local, group, timeout)).numpy()
        lengths = np.asarray(lengths, dtype=np.int64)

    # reduce buckets: one collective per (dtype, fx)
    for (_dtype, fx), specs in plan.reduce_buckets.items():
        flat = torch.cat([torch.as_tensor(state[s.name]).reshape(-1) for s in specs])
        if flat.numel() == 0:
            for s in specs:
                out[s.name] = state[s.name]
            continue
        reduced = _REDUCERS[fx](torch.stack(sync._gather(flat, group, timeout)))
        off = 0
        for s in specs:
            out[s.name] = reduced[off:off + s.item_size].reshape(s.item_shape)
            off += s.item_size

    # cat buckets: one padded ragged collective per dtype
    for _dtype, specs in plan.cat_buckets.items():
        rows = lengths[:, [s.cat_index for s in specs]]  # [world, k]
        elems = rows * np.asarray([s.item_size for s in specs], np.int64)
        max_total = int(elems.sum(axis=1).max())
        # a list whose concat promoted past its first element's dtype is cast
        # back to the plan's dtype, so the collective stays well-formed
        parts = [_local_flat_rows(state[s.name]).to(s.dtype) for s in specs]
        local_flat = torch.cat(parts) if len(parts) > 1 else parts[0]
        if max_total == 0:
            # no rank has a row: skip the collective (max_total is the same
            # on every rank)
            gathered = local_flat.new_zeros((world, 0))
        else:
            padded = torch.nn.functional.pad(local_flat, (0, max_total - local_flat.numel()))
            gathered = torch.stack(sync._gather(padded, group, timeout))  # [world, max_total]
        for j, s in enumerate(specs):
            pieces = []
            for r in range(world):
                start = int(elems[r, :j].sum())
                n = int(elems[r, j])
                pieces.append(gathered[r, start:start + n].reshape((int(rows[r, j]),) + s.item_shape))
            out[s.name] = _assemble_cat(s, pieces, state[s.name], world)

    # unplannable leaves: the per-leaf path, prechecks done by the header
    for s in plan.fallback:
        out[s.name] = sync.host_sync_leaf(state[s.name], reductions.get(s.name), group, precheck=False, timeout=timeout)
    return out
