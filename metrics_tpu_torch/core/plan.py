"""One execution plan: the schema-keyed store, the plan bindings, the one
invalidation path and the whole-step program.

Counterpart of ``metrics_tpu/core/plan.py``:

- :class:`ExecutionPlan`: one per state schema, cached process-wide on the
  exact :func:`~metrics_tpu_torch.parallel.health.state_schema_parts`
  string (the full string, so a CRC collision can never alias two schemas),
  with ``schema_crc`` equal to the health word's schema column. It owns the
  bucketed sync layout (``parallel/bucketing.py``'s classifier; its
  ``build_sync_plan`` is a view over this store), which the blocking sync,
  the overlapped rounds (``parallel/async_sync.py``, from their background
  lane) and the in-program fused sync (``parallel/sync.py::sync_in_jit``)
  share. :func:`plan_for`, :func:`clear_plans`, :func:`plan_cache_info`.
- :class:`PlanBinding`: the per-``Metric``/``MetricCollection`` view: the
  compiled-program namespace of ``core/compiled.py`` (``programs``,
  ``probed``), the overlapped round's ``sync_epoch`` (:func:`next_sync_epoch`)
  and the ``generation`` every invalidation bumps.
- :func:`plan_invalidate`, :func:`mark_state_mutated` and
  :func:`mark_donation_ready`: every state mutation that revokes the compiled
  path's ownership of a metric's state buffers goes through here, and the
  ``plan`` domain of the telemetry registry counts it by reason.
- :func:`compiled_step` and :func:`fused_step_refusal`: ``pure_update`` →
  in-program fused ``sync_in_jit`` (given an axis) → ``pure_compute`` as one
  cached program, a CUDA graph on the card (``core/compiled.py``'s
  :class:`~metrics_tpu_torch.core.compiled.Program`).

On the card, "donation ready" means the metric's state tensors are the
static buffers its CUDA graphs write: the next replay may run on them as they
are. A mutation (a restore, a load, an eager update) or a read that hands a
state tensor out revokes it, and the next dispatch copies the state in again.

Lookups made while a program is built, captured or run, or under
``torch.compile`` (``core/compiled.py::program_context``) stay silent: the
telemetry counts host calls, as the JAX package's counts stay silent under a
trace. ``METRICS_TPU_UNIFIED_PLAN=0`` keeps the store serving the sync
layouts and makes :func:`compiled_step` run the separate phases
(``pure_update``, ``pure_sync``, ``pure_compute``) with no program.

- :class:`TierSchedule` and :func:`tier_schedule_for`: the tier dimension,
  a schema's bucketed layout paired with the negotiated tier topology and
  the subset transport its hops run over (``parallel/tiering.py``), cached
  per ``(schema string, topology key)``.
"""
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.observability.registry import registry_of

__all__ = [
    "ExecutionPlan",
    "PlanBinding",
    "TierSchedule",
    "UNIFIED_PLAN_ENV",
    "binding",
    "clear_plans",
    "compiled_step",
    "fused_step_refusal",
    "mark_donation_ready",
    "mark_state_mutated",
    "next_sync_epoch",
    "peek_binding",
    "plan_cache_info",
    "plan_for",
    "plan_invalidate",
    "tier_schedule_for",
    "unified_plan_enabled",
]

#: Env escape hatch: 0/false/off/no runs ``compiled_step`` as separate phases.
UNIFIED_PLAN_ENV = "METRICS_TPU_UNIFIED_PLAN"


def unified_plan_enabled() -> bool:
    """Default policy: the unified plan is on, unless the env knob opts out."""
    return os.environ.get(UNIFIED_PLAN_ENV, "1").strip().lower() not in ("0", "false", "off", "no")


# ---------------------------------------------------------------------------
# the plan store: one ExecutionPlan per schema, process-wide
# ---------------------------------------------------------------------------


class ExecutionPlan:
    """Everything derived from one state schema, built once and shared.

    ``schema_key`` is the exact schema string, ``schema_crc`` its CRC-32 (the
    health word's schema column), ``sync_layout`` the bucketed sync layout
    (:class:`~metrics_tpu_torch.parallel.bucketing.SyncPlan`). Immutable after
    construction; the store is lock-protected, so overlapped rounds reuse
    plans from their background lane.
    """

    __slots__ = ("schema_key", "schema_crc", "sync_layout")

    def __init__(self, schema_key: str, sync_layout: Any) -> None:
        self.schema_key = schema_key
        self.schema_crc = zlib.crc32(schema_key.encode()) & 0x7FFFFFFF
        self.sync_layout = sync_layout

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ExecutionPlan(crc={self.schema_crc}, buckets={self.sync_layout.n_buckets})"


_PLANS: Dict[str, ExecutionPlan] = {}
_PLANS_LOCK = threading.Lock()
_PLAN_CACHE_MAX = 256
_plan_stats = {"hits": 0, "misses": 0, "invalidations": 0}


def clear_plans() -> None:
    """Drop every cached :class:`ExecutionPlan` and zero the store counters
    (``parallel.bucketing.clear_sync_plan_cache`` is the alias)."""
    with _PLANS_LOCK:
        _PLANS.clear()
        _TIER_SCHEDULES.clear()
        _plan_stats.update(hits=0, misses=0, invalidations=0)


def plan_cache_info() -> Dict[str, int]:
    """``{"size", "hits", "misses", "invalidations"}`` of the store."""
    with _PLANS_LOCK:
        return {"size": len(_PLANS), **_plan_stats}


def plan_for(state: Dict[str, Any], reductions: Dict[str, Any], owner: Any = None) -> ExecutionPlan:
    """The cached :class:`ExecutionPlan` of this state's schema.

    A change a rank may make between syncs (a CatBuffer fixing its item
    shape, a dtype cast) keys a fresh plan; the syncs of one schema (every
    ``compute()`` of a long eval) hit the cache. ``owner`` (a metric or
    collection) takes the build or hit into its ``plan`` telemetry domain.
    """
    from metrics_tpu_torch.core.compiled import program_context
    from metrics_tpu_torch.parallel.health import state_schema_parts

    key = state_schema_parts(state, reductions)
    host_side = not program_context()
    with _PLANS_LOCK:
        plan = _PLANS.get(key)
        if plan is not None:
            _plan_stats["hits"] += 1
    if plan is not None:
        if host_side:
            if owner is not None:
                registry_of(owner).domain("plan")["cache_hits"] += 1
            if journal.ACTIVE:
                journal.record("plan.hit", schema_crc=plan.schema_crc)
        return plan
    from metrics_tpu_torch.parallel.bucketing import _classify

    plan = ExecutionPlan(key, _classify(state, reductions, key))
    if host_side:
        if owner is not None:
            registry_of(owner).domain("plan")["builds"] += 1
        if journal.ACTIVE:
            journal.record("plan.build", schema_crc=plan.schema_crc, buckets=plan.sync_layout.n_buckets)
            # the bucketed-layout event predates the store, as in the JAX package
            journal.record("sync.plan", buckets=plan.sync_layout.n_buckets,
                           cat_leaves=len(plan.sync_layout.cat_leaves))
    with _PLANS_LOCK:
        _plan_stats["misses"] += 1
        if len(_PLANS) >= _PLAN_CACHE_MAX:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = plan
    return plan


# ---------------------------------------------------------------------------
# the tier dimension: the sync layout x the negotiated tier topology
# ---------------------------------------------------------------------------


class TierSchedule:
    """One schema's two-level schedule over one tier topology: the layout
    says what rides each collective, the
    :class:`~metrics_tpu_torch.parallel.tiering.TierTopology` who takes part
    in each hop, ``transport`` what the hops run over. The slow hop has
    ``inter_participants`` (the tier leaders) where the flat gather has
    ``flat_participants`` (every live rank), for ``hops_per_bucket`` = 3
    hops where the flat path has one."""

    __slots__ = ("topology", "transport", "schema_key")

    def __init__(self, topology: Any, transport: Any, schema_key: str) -> None:
        self.topology = topology
        self.transport = transport
        self.schema_key = schema_key

    @property
    def inter_participants(self) -> int:
        return self.topology.n_tiers

    @property
    def flat_participants(self) -> int:
        return len(self.topology.live)

    @property
    def hops_per_bucket(self) -> int:
        return 3

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TierSchedule(tiers={self.topology.n_tiers}, live={len(self.topology.live)})"


_TIER_SCHEDULES: Dict[Any, TierSchedule] = {}


def tier_schedule_for(sync_plan: Any) -> Optional[TierSchedule]:
    """The tiered schedule of one bucketed layout, or ``None`` for the flat
    path (no tier map, no transport, a degenerate topology:
    ``parallel/tiering.py`` decides). A quorum shrink changes the topology
    key, so the schema is scheduled anew in the new epoch with no
    collective. Journals ``plan.tier`` when it builds one."""
    from metrics_tpu_torch.parallel import tiering

    topo = tiering.active_topology()
    if topo is None or sync_plan is None:
        return None
    schema_key = getattr(sync_plan, "schema_key", "")
    key = (schema_key, topo.key)
    with _PLANS_LOCK:
        sched = _TIER_SCHEDULES.get(key)
    transport = tiering.active_tier_transport()
    if sched is not None and sched.transport is transport:
        return sched
    sched = TierSchedule(topo, transport, schema_key)
    with _PLANS_LOCK:
        if len(_TIER_SCHEDULES) >= _PLAN_CACHE_MAX:
            _TIER_SCHEDULES.clear()
        _TIER_SCHEDULES[key] = sched
    if journal.ACTIVE:
        journal.record(
            "plan.tier", schema_crc=zlib.crc32(schema_key.encode()) & 0x7FFFFFFF, tiers=topo.n_tiers,
            inter_participants=sched.inter_participants, flat_participants=sched.flat_participants,
        )
    return sched


# ---------------------------------------------------------------------------
# per-owner bindings
# ---------------------------------------------------------------------------


class PlanBinding:
    """Per-instance plan state: the compiled-program namespace (``programs``,
    ``probed``), the overlapped round counter ``sync_epoch`` (mirrored onto
    the owner's ``_sync_epoch``, which the health word carries) and the
    ``generation`` bumped by every :func:`plan_invalidate`. Never copied or
    pickled: programs hold the original owner's buffers."""

    __slots__ = ("label", "generation", "sync_epoch", "programs", "probed")

    def __init__(self, label: str = "metric") -> None:
        self.label = label
        self.generation = 0
        self.sync_epoch = 0
        self.programs: Dict[Any, Any] = {}
        self.probed: set = set()

    def __deepcopy__(self, memo: dict) -> "PlanBinding":
        return PlanBinding(self.label)

    def __reduce__(self):
        return (PlanBinding, (self.label,))


def binding(owner: Any) -> PlanBinding:
    """The owner's :class:`PlanBinding` (created on first use, with the
    ``plan`` telemetry domain its invalidations count into)."""
    b = owner.__dict__.get("_plan_binding")
    if b is None:
        b = PlanBinding(type(owner).__name__)
        object.__setattr__(owner, "_plan_binding", b)
        registry_of(owner).domain("plan")
    return b


def peek_binding(owner: Any) -> Optional[PlanBinding]:
    """The owner's binding if the plan machinery ever engaged, else ``None``."""
    return owner.__dict__.get("_plan_binding")


def next_sync_epoch(owner: Any) -> int:
    """Advance and return the owner's overlapped-round epoch. The binding
    keeps the counter and mirrors it onto the owner's ``_sync_epoch``, which
    pickles and clones keep although the binding does not."""
    b = binding(owner)
    b.sync_epoch = max(b.sync_epoch, owner.__dict__.get("_sync_epoch", 0)) + 1
    object.__setattr__(owner, "_sync_epoch", b.sync_epoch)
    return b.sync_epoch


# ---------------------------------------------------------------------------
# the single invalidation path
# ---------------------------------------------------------------------------


def plan_invalidate(
    owner: Any, reason: str = "state-mutated", schema_changed: bool = False, groups_stale: bool = False
) -> None:
    """THE invalidation entry: bumps the binding's generation and counts the
    invalidation (by reason) in the owner's ``plan`` telemetry domain and the
    store's counters. A schema change (or ``groups_stale``: a reset, a
    detach) also marks a collection's compute groups stale. One dict lookup
    when no plan machinery ever engaged."""
    d = owner.__dict__
    if (schema_changed or groups_stale) and "_groups_stale" in d:
        object.__setattr__(owner, "_groups_stale", True)
    b = d.get("_plan_binding")
    if b is None:
        return
    b.generation += 1
    with _PLANS_LOCK:
        _plan_stats["invalidations"] += 1
    dom = registry_of(owner).domain("plan")
    dom["invalidations"] += 1
    reasons = dom.setdefault("invalidate_reasons", {})
    reasons[reason] = reasons.get(reason, 0) + 1
    if journal.ACTIVE:
        journal.record(
            "plan.invalidate", label=b.label, reason=reason, schema_changed=schema_changed, generation=b.generation
        )


def mark_state_mutated(
    owner: Any, reason: str = "state-mutated", schema_changed: bool = False, groups_stale: bool = False
) -> None:
    """Clear the donation latch and notify the plan layer. The notification
    fires only on an actual ownership transition (the latch was set), a
    schema change or ``groups_stale`` (the compute groups need planning
    again without a schema change): re-clearing a clear latch is the eager
    path's common case and stays two dict operations."""
    d = owner.__dict__
    owned = d.get("_donation_ready", False)
    if owned:
        object.__setattr__(owner, "_donation_ready", False)
    if owned or schema_changed or groups_stale:
        plan_invalidate(owner, reason, schema_changed=schema_changed, groups_stale=groups_stale)


def mark_donation_ready(owner: Any) -> None:
    """The inverse transition: a compiled dispatch left the owner's state on
    the buffers its programs write. Bookkeeping only, never an invalidation."""
    object.__setattr__(owner, "_donation_ready", True)


# ---------------------------------------------------------------------------
# the whole-step program
# ---------------------------------------------------------------------------


def _members(owner: Any) -> List[Any]:
    from metrics_tpu_torch.core.collections import MetricCollection

    return [m for _k, m in owner.items()] if isinstance(owner, MetricCollection) else [owner]


def fused_step_refusal(owner: Any) -> Optional[str]:
    """Why ``owner`` cannot run the whole-step program (``None``: it can).
    As in the JAX package: every member declares states, none of them a
    growing list, and every state merges algebraically."""
    for m in _members(owner):
        defaults = getattr(m, "_defaults", None)
        if not defaults:
            return f"{type(m).__name__} declares no states (nothing to trace into the fused step)"
        for name, default in defaults.items():
            if isinstance(default, list):
                return (
                    f"{type(m).__name__} state {name!r} is a growing list — "
                    "use with_capacity() for a fixed-shape CatBuffer"
                )
        if not m._can_merge():
            return f"{type(m).__name__} state has no algebraic merge"
    return None


def _maybe_record_fused(owner: Any) -> None:
    """Count one whole-step engagement: every host call, or once per call
    skeleton inside a caller's own capture or ``torch.compile``."""
    from metrics_tpu_torch.core.compiled import program_context

    registry_of(owner).domain("plan")["fused_steps"] += 1
    if journal.ACTIVE and not program_context():
        journal.record("plan.fused_step", label=type(owner).__name__)


def _state_slots(state: Dict[str, Any], keyed: bool) -> List[Tuple[Optional[str], Dict[str, Any]]]:
    """``(member key or None, state dict)`` of a metric's or a collection's
    state."""
    return list(state.items()) if keyed else [(None, state)]


def _step_signature(state: Dict[str, Any], keyed: bool) -> Tuple[Optional[Tuple], Optional[str]]:
    """``(signature, refusal)``: the shapes, dtypes and devices of every
    state leaf; ``None`` when a leaf holds a weakly typed default (an eager
    step fixes its dtype first); a refusal for a CatBuffer state, whose fill
    count is a host value that a replayed compute would read stale."""
    from metrics_tpu_torch.core.cat_buffer import CatBuffer
    from metrics_tpu_torch.core.metric import _is_weak

    sig = []
    for key, sub in _state_slots(state, keyed):
        for name, v in sub.items():
            if isinstance(v, CatBuffer):
                return None, (
                    f"state {name!r} is a CatBuffer: its fill count is a host value that a replayed "
                    "compute() would read as it was at capture"
                )
            if _is_weak(v):
                return None, None
            sig.append((key, name, tuple(v.shape), v.dtype, v.device))
    return tuple(sig), None


def _copy_in(slots: Dict[str, Any], state: Dict[str, Any], keyed: bool) -> None:
    """Bring ``state`` into the program's slots: a leaf that is its slot
    (the caller threaded the returned state back in) stays; any other is
    copied in, aliased leaves each into its own slot."""
    for key, sub in _state_slots(state, keyed):
        slot = slots[key] if keyed else slots
        for name, target in slot.items():
            v = sub[name]
            if v is not target:
                target.copy_(v)


def _returned_state(slots: Dict[str, Any], keyed: bool) -> Dict[str, Any]:
    """The new state handed back: the slot tensors themselves, in dicts of
    the caller's own."""
    return {k: dict(v) for k, v in slots.items()} if keyed else dict(slots)


def compiled_step(
    owner: Any,
    state: Dict[str, Any],
    args: Tuple,
    kwargs: Dict[str, Any],
    axis_name: Optional[Any] = None,
) -> Tuple[Dict[str, Any], Any]:
    """One whole metric step, ``update`` + in-program fused sync + ``compute``,
    as one cached program.

    Returns ``(new_state, values)``: the accumulated state (``pure_update``)
    and the value over its sync over ``axis_name`` (none given: the local
    state), what a blocking ``sync(); compute()`` would serve.

    - **On the card** the eager call is one CUDA graph over static state
      buffers (``core/compiled.py::Program``), cached in the owner's
      :class:`PlanBinding` under ``("step", axis, generation, call skeleton,
      input and state signatures)``. The returned ``new_state`` tensors ARE
      the program's state buffers: thread them back in and the replay runs
      in place, with no copy; any other state dict, or aliased leaves, is
      copied into the buffers first. As with the JAX package's donated scan
      carry, the caller never reuses the state it passed in: the next call
      overwrites it. On the CPU the same function runs directly.
    - **Inside a caller's own capture or ``torch.compile``** the step runs
      inline, into the caller's one program (the JAX package's "inside the
      user's jit").
    - **An axis on an eager call** (a divergence from the JAX package, which
      refuses one there): the port's eager call is its own program, so a
      group a graph can hold is accepted, an NCCL group (a
      ``ProcessGroup``, a ``DeviceMesh`` or ``(DeviceMesh, dim)``) for state
      on the card; the program's eager warm-up sets the communicator up
      before the capture. A group whose backend cannot be captured (gloo)
      for state on the card raises
      :class:`~metrics_tpu_torch.utils.exceptions.MetricsTPUUserError`. On
      the CPU any group of ``sync_in_jit`` is accepted (nothing is captured).

    An update the probe (``probe_traceable``) refuses, a CatBuffer state or
    a capture that fails becomes a cached refusal: the separate phases run
    instead, with the same values, and ``compile_stats()["fallback"]["step"]``
    says why, with a one-time warning.
    """
    from metrics_tpu_torch.core.collections import MetricCollection
    from metrics_tpu_torch.core.compiled import (
        CaptureError,
        Program,
        dispatch_program,
        probe_traceable,
        program_context,
        rebuild_call,
        split_call,
        tensor_signature,
    )
    from metrics_tpu_torch.parallel import sync as sync_mod
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    reason = fused_step_refusal(owner)
    if reason is not None:
        raise MetricsTPUUserError(f"whole-step fused program refused for {type(owner).__name__}: {reason}.")
    keyed = isinstance(owner, MetricCollection)
    if keyed:
        # plan the compute groups now, on the host: the first pure_update
        # would build them inside the program
        owner._ensure_groups()

    def separate(st: Dict[str, Any], a: Tuple, kw: Dict[str, Any]) -> Tuple[Dict[str, Any], Any]:
        new_state = owner.pure_update(st, *a, **kw)
        synced = owner.pure_sync(new_state, axis_name=axis_name, fused=True) if axis_name is not None else new_state
        return new_state, owner.pure_compute(synced)

    if not unified_plan_enabled():
        return separate(state, args, kwargs)
    try:
        treedef, dyn_ix, statics, dynamic = split_call(args, kwargs)
    except TypeError:
        raise MetricsTPUUserError(
            "whole-step fused program: arguments contain unhashable non-array values; "
            "pass tensors and hashable statics only."
        ) from None

    b = binding(owner)
    key = ("step", axis_name, b.generation, treedef, dyn_ix, statics)

    def traced(st: Dict[str, Any], dyn: List[Any]) -> Tuple[Dict[str, Any], Any]:
        a, kw = rebuild_call(treedef, dyn_ix, statics, dyn)
        return separate(st, a, kw)

    if program_context():
        # inside the caller's capture or torch.compile: inline, counted once
        # per call skeleton
        fn = b.programs.get(key)
        if fn is None:
            b.programs[key] = fn = traced
            _maybe_record_fused(owner)
        return fn(state, list(dynamic))

    _maybe_record_fused(owner)
    sig, refusal = _step_signature(state, keyed)
    state_device = sig[0][4] if sig else None
    if axis_name is not None and state_device is not None and state_device.type == "cuda":
        sync_mod.check_capturable_axis(axis_name)
    disp = owner._compiled_dispatcher()
    if refusal is not None:
        if "step" not in disp.fallback:
            disp.mark_fallback("step", refusal)
        return separate(state, args, kwargs)
    if sig is None or any(t.device != state_device for t in dynamic):
        return separate(state, args, kwargs)  # a weak default, or inputs elsewhere: eager this call
    pkey = key + (tensor_signature(dynamic), sig)
    prog = b.programs.get(pkey)
    if prog is None:
        members = [owner] + (_members(owner) if keyed else [])

        def update_and_compute(st: Dict[str, Any], dyn: List[Any]) -> Any:
            # the probe: the sync is this package's own collectives
            a, kw = rebuild_call(treedef, dyn_ix, statics, dyn)
            return owner.pure_compute(owner.pure_update(st, *a, **kw))

        untraceable = probe_traceable(update_and_compute, state, dynamic, members)
        if untraceable is not None:
            prog = b.programs[pkey] = untraceable
            disp.mark_fallback("step", untraceable)
        else:
            from metrics_tpu_torch.core.compiled import _clone_leaf

            slots = {k: _clone_leaf(v) for k, v in state.items()} if keyed else _clone_leaf(state)
            pairs = [(slots[k], k) for k in slots] if keyed else [(slots, None)]
            try:
                prog = disp.program(
                    pkey, lambda: Program.build(traced, slots, pairs, dynamic, state_device, disp.pool(state_device)))
            except CaptureError as err:
                prog = b.programs[pkey] = f"compiled step failed ({err})"
                disp.mark_fallback("step", prog)
    if not isinstance(prog, Program):
        return separate(state, args, kwargs)  # a refusal, or a state that changes shape (eager)
    _copy_in(prog.slots, state, keyed)
    values = dispatch_program(disp, "step", prog, dynamic)
    return _returned_state(prog.slots, keyed), values
