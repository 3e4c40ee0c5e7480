"""Bucketed host sync: one collective per dtype/reduction class, not per leaf.

Counterpart of ``metrics_tpu/parallel/bucketing.py``.
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

**The tiered schedule.** With a tier map and a subset transport
(``parallel/tiering.py``; the default world only), each bucket's one flat
gather becomes three hops: a gather within the tier (fast hop), ONE exchange
between the tier leaders (slow hop), and a gather within the tier again that
hands every member the leaders' result. At full precision the blocks move
raw, so the result is the flat gather's, bit for bit.
``sync_precision`` ("bf16"/"int8", ``parallel/quantize.py``) encodes the
slow hop's wire alone, on the state's device (so a host transport copies
the smaller wire): a float reduce bucket is reduced within the tier first
(float32), the tier partials cross encoded and combine with a Kahan sum in
tier order; a cat bucket's padded blocks cross encoded. Integer buckets pass
raw. Each hop adds its bytes to ``intra_tier_bytes`` / ``inter_tier_bytes``
/ ``inter_tier_bytes_saved`` of the owner's ``sync`` telemetry and journals
``sync.hop``. Without a topology the flat path runs, with no extra
collective.

The caller must have verified the gathered health words first:
``host_sync_state`` does, and is the entry point. ``METRICS_TPU_FUSED_SYNC=0``
restores the per-leaf path.
"""
import time
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.parallel.health import (
    cat_family_names,
    cat_row_count,
    header_cat_lengths,
)
from metrics_tpu_torch.parallel.sync import _divide, _mean_over_ranks, _rank_order_total, _sum_keep_dtype

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


_REDUCERS = {
    "sum": _sum_keep_dtype,
    "mean": _mean_over_ranks,
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


# ---------------------------------------------------------------------------
# the two-level (tiered) schedule
# ---------------------------------------------------------------------------


def _bump_stats(stats: Optional[Dict[str, Any]], key: str, by: float) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + by


def _tier_collective(transport: Any, x: torch.Tensor, ranks: Any, timeout: Optional[float],
                     what: str) -> torch.Tensor:
    """One watchdog-guarded subset gather over ``ranks``, the schedule's one
    primitive: ``x`` goes to the transport on its own device, the stacked
    result comes back to it."""
    from metrics_tpu_torch.parallel.health import call_with_sync_watchdog

    return call_with_sync_watchdog(
        lambda: torch.as_tensor(transport.subset_allgather(x, frozenset(ranks))), timeout=timeout, what=what
    ).to(x.device)


def _account_hop(stats: Optional[Dict[str, Any]], topo: Any, hop: str, nbytes: int, participants: int,
                 dur_s: float) -> None:
    """A hop's byte counter and ``sync.hop`` event. ``nbytes`` is what this
    rank put on the wire for the hop (its payload times the other
    participants), as the JAX package counts it."""
    _bump_stats(stats, "intra_tier_bytes" if hop == "intra" else "inter_tier_bytes", int(nbytes))
    if journal.ACTIVE:
        journal.record(
            "sync.hop", label=hop, tier=-1 if topo.my_tier is None else int(topo.my_tier),
            participants=int(participants), nbytes=int(nbytes), dur_s=float(dur_s),
        )


def _exchange(topo: Any, transport: Any, timeout: Optional[float], stats: Optional[Dict[str, Any]], item: int,
              n: int, wire: Optional[torch.Tensor], enc_n: int, wire_dtype: torch.dtype, device: torch.device,
              ) -> torch.Tensor:
    """The slow hop and the broadcast back into the tier: the leader sends
    ``wire`` (``enc_n`` elements) to the other leaders; every member then
    takes the leaders' ``[n_tiers, enc_n]`` rows from its leader. Counts
    ``inter_tier_bytes_saved`` against the flat gather's ``n``-element
    payload of ``item`` bytes."""
    wire_item = torch.empty((), dtype=wire_dtype).element_size()
    k = len(topo.my_tier_ranks)
    if topo.is_leader:
        t0 = time.monotonic()
        inter = _tier_collective(transport, wire, topo.leaders, timeout, "tier inter-exchange")
        actual_inter = enc_n * wire_item * (topo.n_tiers - 1)
        _account_hop(stats, topo, "inter", actual_inter, topo.n_tiers, time.monotonic() - t0)
        bc_payload = inter.reshape(-1)
    else:
        bc_payload = torch.zeros((topo.n_tiers * enc_n,), dtype=wire_dtype, device=device)
        actual_inter = 0
    # what the flat gather would have moved across tiers from this rank (its
    # payload to every rank outside its tier) less what the schedule moved
    _bump_stats(stats, "inter_tier_bytes_saved", n * item * (len(topo.live) - k) - actual_inter)
    t0 = time.monotonic()
    bc = _tier_collective(transport, bc_payload, topo.my_tier_ranks, timeout, "tier broadcast")
    _account_hop(stats, topo, "intra", bc_payload.numel() * wire_item * (k - 1), k, time.monotonic() - t0)
    return bc[0].reshape(topo.n_tiers, enc_n)  # the leader is the min rank: row 0


def _intra_gather(flat: torch.Tensor, topo: Any, transport: Any, timeout: Optional[float],
                  stats: Optional[Dict[str, Any]]) -> torch.Tensor:
    k = len(topo.my_tier_ranks)
    t0 = time.monotonic()
    block = _tier_collective(transport, flat, topo.my_tier_ranks, timeout, "tier intra-gather")
    _account_hop(stats, topo, "intra", flat.numel() * flat.element_size() * (k - 1), k, time.monotonic() - t0)
    return block


def _tiered_allgather(flat: torch.Tensor, topo: Any, transport: Any, timeout: Optional[float],
                      stats: Optional[Dict[str, Any]], precision: Optional[str] = None) -> torch.Tensor:
    """The tiered replacement of one flat gather of ``flat``: the ``[world,
    n]`` matrix in rank order (``topo.assembly``). Full precision moves the
    blocks raw: the flat gather's rows, bit for bit. ``precision`` encodes
    the slow hop's padded tier blocks (float payloads only)."""
    from metrics_tpu_torch.parallel import quantize

    n = flat.numel()
    block = _intra_gather(flat, topo, transport, timeout, stats)
    width = topo.max_tier * n
    if not flat.dtype.is_floating_point:
        precision = None  # fixed by the schema: the same on every rank
    enc_n = quantize.encoded_size(width, flat.dtype, precision)
    wire_dtype = flat.dtype if precision is None else (torch.bfloat16 if precision == "bf16" else torch.int8)
    wire = None
    if topo.is_leader:
        payload = torch.nn.functional.pad(block.reshape(-1), (0, width - block.numel()))
        wire = quantize.encode(payload, precision)
    rows = _exchange(topo, transport, timeout, stats, flat.element_size(), n, wire, enc_n, wire_dtype, flat.device)
    decoded = quantize.decode(rows, width, flat.dtype, precision)  # [n_tiers, width]
    return decoded.reshape(topo.n_tiers * topo.max_tier, n)[torch.as_tensor(topo.assembly, device=flat.device)]


def _tiered_quantized_reduce(flat: torch.Tensor, fx: str, topo: Any, transport: Any, timeout: Optional[float],
                             stats: Optional[Dict[str, Any]], precision: str) -> torch.Tensor:
    """The quantized slow hop of a float reduce bucket: reduced within the
    tier at full precision (float32), the partial encoded, ONE exchange of
    the encoded partials, decoded and combined across tiers (a Kahan sum in
    tier order; a mean divides by the live count). Deterministic, so
    bit-stable from run to run."""
    from metrics_tpu_torch.parallel import quantize

    n = flat.numel()
    block = _intra_gather(flat, topo, transport, timeout, stats)
    if fx in ("sum", "mean"):
        partial = _rank_order_total(block.to(torch.float32))  # XLA's order: the JAX package's codes
    elif fx == "max":
        partial = torch.amax(block, dim=0).to(torch.float32)
    else:
        partial = torch.amin(block, dim=0).to(torch.float32)
    wire = quantize.encode(partial, precision)
    rows = _exchange(topo, transport, timeout, stats, flat.element_size(), n, wire, wire.numel(), wire.dtype,
                     flat.device)
    partials = quantize.decode(rows, n, torch.float32, precision)
    if fx == "sum":
        combined = quantize.kahan_sum(partials)
    elif fx == "mean":
        combined = _divide(quantize.kahan_sum(partials), len(topo.live))
    elif fx == "max":
        combined = torch.amax(partials, dim=0)
    else:
        combined = torch.amin(partials, dim=0)
    return combined.to(flat.dtype)


def host_sync_state_bucketed(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    words: Optional[np.ndarray] = None,
    group: Optional[Any] = None,
    timeout: Optional[float] = None,
    sync_precision: Optional[str] = None,
    stats: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Bucketed payload sync of a whole (possibly collection-combined) state.

    The caller verified the gathered health ``words``: the plan assumes equal
    schemas, non-empty cat states, clean CatBuffers, and the same tier
    topology and payload precision on every rank (the v5 columns). Issues
    one collective per reduce bucket and per cat bucket (three hops each on
    the tiered schedule of a default-world sync, see the module docstring),
    the per-leaf cost of callable-``fx`` leaves, and one length-vector
    gather only past ``CAT_LENGTH_SLOTS`` cat-family states. ``stats`` (the
    owner's ``sync`` telemetry) takes the tier byte counters.
    """
    from metrics_tpu_torch.core import plan as plan_mod
    from metrics_tpu_torch.parallel import sync
    from metrics_tpu_torch.parallel.quantize import validate_sync_precision

    world = sync._sync_world(group)
    plan = build_sync_plan(state, reductions)
    precision = validate_sync_precision(sync_precision)
    sched = plan_mod.tier_schedule_for(plan) if group is None else None
    topo = sched.topology if sched is not None else None
    transport = sched.transport if sched is not None else None
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
        if topo is None:
            reduced = _REDUCERS[fx](torch.stack(sync._gather(flat, group, timeout)))
        elif precision is not None and flat.dtype.is_floating_point:
            reduced = _tiered_quantized_reduce(flat, fx, topo, transport, timeout, stats, precision)
        else:
            reduced = _REDUCERS[fx](_tiered_allgather(flat, topo, transport, timeout, stats))
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
            if topo is None:
                gathered = torch.stack(sync._gather(padded, group, timeout))  # [world, max_total]
            else:
                # the slow hop encoded iff a precision is set and the dtype is float
                gathered = _tiered_allgather(padded, topo, transport, timeout, stats, precision)
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
