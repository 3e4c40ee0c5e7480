"""``MetricCollection``: several metrics fed by one ``update``/``forward`` call.

Counterpart of ``metrics_tpu/core/collections.py``: a dict of metrics (sorted
by key when built from a dict), prefix/postfix on the output keys, keyword
filtering by each member's ``update`` signature,
update/forward/compute/reset/clone/state_dict, and its two performance seams:

- **Compute groups.** Members whose state schema
  (:meth:`~metrics_tpu_torch.Metric.state_fingerprint`) and update
  (:meth:`~metrics_tpu_torch.Metric.update_identity`) are the same run one
  update per step and hold one copy of state: Precision, Recall, F1 and
  Specificity with equal arguments pay for one stat-score update, and ROC,
  PrecisionRecallCurve and AveragePrecision share one preds/target
  accumulation. Each member still computes its own value, so the results
  are the same bits as ungrouped. ``compute_groups=True`` (the default)
  groups automatically, a list of key lists pins the groups, ``False`` or
  ``METRICS_TPU_COMPUTE_GROUPS=0`` disables.
- **The fused collection sync.** :meth:`MetricCollection.sync` combines
  every member's state (one per group) into one key-prefixed dict and syncs
  it through one health header and one bucketed plan
  (``parallel/bucketing.py``); ``compute()`` in a distributed run syncs the
  collection so, once, and the members compute from the synced state.

- **The compiled hot path.** After the warm-up, every eligible unit (a
  compute group's leader or a solo member) updates in ONE program a step
  (``core/compiled.py``: a CUDA graph on the card), and a compute group's
  ``forward`` runs as one program; members the probe refuses stay eager
  and the program shrinks around them.
- **The pure state API**: ``init_state``, ``pure_update``, ``pure_compute``,
  ``pure_forward`` and ``merge_states``, keyed by member, one update per
  compute group.

- **The overlapped collection sync.** ``sync(blocking=False)`` (and
  ``sync_mode="overlap"``) launches ONE round over the combined payload on
  the background lane (``parallel/async_sync.py``); the next read resolves
  it for every member, all or nothing.
- **The whole step as one program**: ``compiled_step`` and the in-program
  ``pure_sync`` (``core/plan.py``, ``parallel/sync.py::sync_in_jit``).

``telemetry()`` returns the collection's snapshot and every member's
(``{"collection": ..., "members": {key: ...}}``); the planner journals
``group.form`` and ``group.detach``, a failed fused sync ``health.failure``.
It is a ``torch.nn.ModuleDict``, as upstream TorchMetrics' is, so ``.to()``
moves every member.
"""
import os
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from metrics_tpu_torch.core import plan as plan_mod
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.compiled import (
    CaptureError,
    CompiledDispatcher,
    Program,
    compile_stats_view,
    compiled_update_enabled,
    compiled_warmup,
    consult_static,
    dispatch_program,
    probe_traceable,
    rebuild_call,
    split_call,
    state_signature,
    tensor_signature,
)
from metrics_tpu_torch.core.metric import (
    _SYNC_MODES,
    Metric,
    _check_on_error,
    _ComputeGroup,
    _fire_checkpointer,
    _fresh_state_value,
    _is_weak,
    _raise_on_catbuffer_overflow,
    _set_state,
)
from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.observability.diagnostics import warn_once
from metrics_tpu_torch.observability.registry import registry_of
from metrics_tpu_torch.parallel import bucketing
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.parallel.async_sync import drain_round, launch_round, resolve_round, validate_staleness_policy
from metrics_tpu_torch.parallel.health import FUSED_KEY_SEP, is_missing_rank_error
from metrics_tpu_torch.parallel.quantize import validate_sync_precision
from metrics_tpu_torch.utils.exceptions import (
    MetricsTPUUserError,
    StaleSyncError,
    StateDictMismatchError,
    SyncError,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn

#: Env escape hatch: 0/false/off/no disables compute-group formation.
COMPUTE_GROUPS_ENV = "METRICS_TPU_COMPUTE_GROUPS"


def compute_groups_enabled() -> bool:
    """Default grouping policy: on, unless the env knob opts the process out."""
    return os.environ.get(COMPUTE_GROUPS_ENV, "1").strip().lower() not in ("0", "false", "off", "no")


def _static_grouping_hazards(m: Metric) -> List[str]:
    """metricslint validation of a compute-group candidate: reasons the
    class's update provably breaks the grouping contract (writes an attr
    that is neither an ``add_state`` state nor a declared
    ``_group_shared_attrs`` latch). Empty when clean, unresolvable, or
    pre-classification is disabled (``METRICS_TPU_ANALYSIS_PRECLASSIFY=0``).
    Deterministic from source, so every rank plans the same partition."""
    from metrics_tpu_torch.analysis.runtime import grouping_hazards

    return grouping_hazards(m)


def _leaf_concrete_equal(a: Any, b: Any) -> bool:
    """Bit-equality of two state leaves (reads the device)."""
    if a is b:
        return True
    if isinstance(a, CatBuffer) or isinstance(b, CatBuffer):
        if not (isinstance(a, CatBuffer) and isinstance(b, CatBuffer)):
            return False
        if (a.capacity, a.count, a.overflowed) != (b.capacity, b.count, b.overflowed):
            return False
        if (a.buffer is None) != (b.buffer is None):
            return False
        return a.buffer is None or _leaf_concrete_equal(a.buffer, b.buffer)
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if not (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))) or len(a) != len(b):
            return False
        return all(_leaf_concrete_equal(x, y) for x, y in zip(a, b))
    return (
        a.dtype == b.dtype and a.shape == b.shape and a.device == b.device and bool(torch.equal(a, b))
    )


def _concrete_states_equal(a: Metric, b: Metric) -> bool:
    """Can ``b`` share ``a``'s state right now? Equal update counts (the sync
    header would diverge otherwise) and bit-equal state leaves."""
    if a._is_synced or b._is_synced:
        return False
    if a._update_count != b._update_count:
        return False
    if sorted(a._defaults) != sorted(b._defaults):
        return False
    return all(_leaf_concrete_equal(getattr(a, name), getattr(b, name)) for name in a._defaults)


class MetricCollection(nn.ModuleDict):
    """An ordered dict of metrics sharing a single ``update``/``forward``
    call — pass the superset of inputs once and each member picks the
    keyword arguments its ``update`` accepts.

    A direct ``update``/``forward``/``reset``/``load_state_dict``, cast or
    state assignment on one grouped member copies its state and takes it out
    of its group, so its siblings never see it; a group whose dispatch
    raised breaks up, and ``reset()`` plans the groups again.

    Args:
        metrics: one Metric, a list/tuple of Metrics, or a dict name->Metric.
        prefix / postfix: added to every key in the output dict.
        compute_groups: ``True`` groups schema- and update-identical members,
            a list of key lists pins the groups, ``False`` disables.
        sync_mode: ``"overlap"`` makes ``compute()`` resolve one collection
            round launched at the previous ``compute()`` and launch the next
            (see :attr:`Metric.sync_mode`).
        staleness_policy: what a stale collection round serves, one policy
            for the whole round (see :attr:`Metric.staleness_policy`).
        sync_precision: the slow-hop codec of the combined sync's tiered
            schedule, one for the whole combined gather (see
            ``Metric(sync_precision=)``).

    A combined sync (fused or overlapped) runs under ``on_missing="quorum"``
    only when every member asks for it (one transport serves them all), and
    degrades a missing-rank failure when any member asks for ``"local"``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricCollection, StatScores
        >>> mc = MetricCollection({"acc": Accuracy(num_classes=3, device="cpu"),
        ...                        "stats": StatScores(reduce="micro", num_classes=3, device="cpu")})
        >>> vals = mc(torch.tensor([0, 2, 1]), torch.tensor([0, 1, 1]))
        >>> round(float(vals["acc"]), 4), vals["stats"].tolist()
        (0.6667, [2, 1, 5, 1, 3])
    """

    #: The slow-hop codec of the combined sync (``None``: full precision).
    sync_precision: Optional[str] = None

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, Sequence[Sequence[str]]] = True,
        sync_mode: str = "blocking",
        staleness_policy: str = "snapshot",
        sync_precision: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        if sync_mode not in _SYNC_MODES:
            raise MetricsTPUUserError(f"`sync_mode` must be one of {_SYNC_MODES}, got {sync_mode!r}")
        self.sync_mode = sync_mode
        self.staleness_policy = validate_staleness_policy(staleness_policy)
        self.sync_precision = validate_sync_precision(sync_precision)
        self._inflight_round = None
        self._inflight_owners: Optional[List[Tuple[str, Metric, List[Metric]]]] = None
        self._inflight_counts: Optional[Dict[str, int]] = None
        self._sync_epoch = 0
        self._overlap_warned = False
        if not (
            isinstance(compute_groups, bool)
            or (
                isinstance(compute_groups, (list, tuple))
                and all(isinstance(g, (list, tuple)) and all(isinstance(k, str) for k in g) for g in compute_groups)
            )
        ):
            raise MetricsTPUUserError(
                f"`compute_groups` must be a bool or a list of lists of metric keys, got {compute_groups!r}"
            )
        self._compute_groups_arg = compute_groups
        self._groups_stale = True
        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def add_metrics(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                raise ValueError(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of `Metric` or `MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = type(metric).__name__
                    if name in self:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")
        # membership changed: plan the groups again at the next dispatch
        plan_mod.plan_invalidate(self, "membership-changed", schema_changed=True)

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def items(self, keep_base: bool = True) -> Iterable[Tuple[str, Metric]]:  # type: ignore[override]
        """Default keeps base keys; pass ``keep_base=False`` for the
        prefixed/postfixed view."""
        if keep_base:
            return super().items()
        return [(self._set_name(k), v) for k, v in super().items()]

    def keys(self, keep_base: bool = True) -> Iterable[str]:  # type: ignore[override]
        if keep_base:
            return super().keys()
        return [self._set_name(k) for k in super().keys()]

    # ---------------- compute-group planner ----------------

    @property
    def compute_group_keys(self) -> List[List[str]]:
        """The compute groups as lists of member keys, in collection order
        (empty when grouping is off or no members qualify). Plans lazily."""
        self._ensure_groups()
        groups: Dict[int, List[str]] = {}
        for k, m in super().items():
            if m._compute_group is not None:
                groups.setdefault(id(m._compute_group), []).append(k)
        return [keys for keys in groups.values() if len(keys) >= 2]

    def _iter_group_objects(self) -> Iterator[_ComputeGroup]:
        seen: set = set()
        for m in super().values():
            g = m._compute_group
            if g is not None and id(g) not in seen:
                seen.add(id(g))
                yield g

    def _ensure_groups(self) -> None:
        """Plan the compute groups, when membership, a reset, a load or a
        failed dispatch made the plan stale.

        Members group when they have (a) an equal, non-``None``
        ``update_identity``, (b) an equal ``state_fingerprint``, (c) equal
        sync configuration (a group syncs through one member) and (d)
        bit-equal current state. The same construction and feed give the
        same groups on every rank; where ranks diverged, the fused sync's
        combined header catches the different key sets before any payload.
        """
        if not self._groups_stale:
            return
        self._groups_stale = False
        self._dissolve_groups()
        arg = self._compute_groups_arg
        if arg is False or not compute_groups_enabled():
            return
        members = list(super().items())
        if len(members) < 2:
            return
        if isinstance(arg, (list, tuple)):
            self._link_explicit_groups(arg, dict(members))
            return
        # a metric registered under several keys updates once per key, and
        # must never group with itself
        occurrences: Dict[int, int] = {}
        for _k, m in members:
            occurrences[id(m)] = occurrences.get(id(m), 0) + 1
        buckets: Dict[Any, List[Tuple[str, Metric]]] = {}
        for k, m in members:
            if m._is_synced or occurrences[id(m)] > 1:
                continue
            ident = m._effective_update_identity()
            if ident is None:
                continue
            hazards = _static_grouping_hazards(m)
            if hazards:
                # the class declares an update_identity, but its update
                # latches an undeclared attribute: it stays solo, and says
                # why once per class
                warn_once(
                    ("group-static-hazard", type(m)),
                    f"{type(m).__name__} declares update_identity() but is excluded from compute groups: "
                    + "; ".join(hazards[:3])
                    + ". Declare the attribute(s) in _group_shared_attrs (or with add_state) to restore grouping.",
                    UserWarning,
                )
                continue
            key = (ident, m.state_fingerprint()) + self._sync_config_key(m)
            buckets.setdefault(key, []).append((k, m))
        for bucket in buckets.values():
            if len(bucket) < 2:
                continue
            # only members that are bit-equal right now may share
            subgroups: List[List[Tuple[str, Metric]]] = []
            for k, m in bucket:
                for sg in subgroups:
                    if _concrete_states_equal(sg[0][1], m):
                        sg.append((k, m))
                        break
                else:
                    subgroups.append([(k, m)])
            for sg in subgroups:
                if len(sg) >= 2:
                    self._link_group(sg)

    @staticmethod
    def _sync_config_key(m: Metric) -> Tuple:
        """What a group must agree on beyond the schema: it syncs and merges
        through one member, whose knobs speak for all, on one device."""
        return (
            None if m.process_group is None else id(m.process_group),
            None if m.dist_sync_fn is None else id(m.dist_sync_fn),
            m.sync_on_error,
            bool(m.sync_strict_update_count),
            m.sync_fused,
            m.sync_timeout,
            id(type(m).merge_states),
            str(m.device),
        )

    def _link_explicit_groups(self, spec: Sequence[Sequence[str]], by_key: Dict[str, Metric]) -> None:
        seen: set = set()
        occurrences: Dict[int, int] = {}
        for m in by_key.values():
            occurrences[id(m)] = occurrences.get(id(m), 0) + 1
        for group_keys in spec:
            keys = list(group_keys)
            for k in keys:
                if k not in by_key:
                    raise MetricsTPUUserError(
                        f"compute_groups override names unknown metric {k!r}; collection keys are {sorted(by_key)}"
                    )
                if k in seen:
                    raise MetricsTPUUserError(f"compute_groups override lists metric {k!r} in more than one group")
                seen.add(k)
            if len(keys) < 2:
                continue
            ms = [by_key[k] for k in keys]
            if any(occurrences[id(m)] > 1 for m in ms):
                raise MetricsTPUUserError(
                    f"compute_groups override groups {keys}, but at least one of those metrics is "
                    "registered under several collection keys: a metric registered under several "
                    "keys updates once per key and cannot join a compute group."
                )
            for k, m in zip(keys, ms):
                hazards = _static_grouping_hazards(m)
                if hazards:
                    # an explicit override is the user's promise, but the
                    # static report refutes it with a concrete attr+line:
                    # shared dispatch would skip that latch on every
                    # non-dispatching sibling — refuse loudly
                    raise MetricsTPUUserError(
                        f"compute_groups override groups {keys}, but metricslint statically refutes "
                        f"{k!r} ({type(m).__name__}) as a group member: " + "; ".join(hazards[:3])
                        + ". Declare the attribute(s) in _group_shared_attrs (or with add_state), "
                        "or remove the metric from the explicit group."
                    )
            fp0, cfg0 = ms[0].state_fingerprint(), self._sync_config_key(ms[0])
            for k, m in zip(keys[1:], ms[1:]):
                if m.state_fingerprint() != fp0:
                    raise MetricsTPUUserError(
                        f"compute_groups override groups {keys}, but {k!r} declares a different state "
                        f"schema than {keys[0]!r}: compute-group members must have identical "
                        "`add_state` declarations (name/shape/dtype/default/dist_reduce_fx)."
                    )
                if self._sync_config_key(m) != cfg0:
                    raise MetricsTPUUserError(
                        f"compute_groups override groups {keys}, but {k!r} is configured differently "
                        f"from {keys[0]!r} (process_group / dist_sync_fn / sync_on_error / "
                        "sync_strict_update_count / sync_fused / sync_timeout / merge_states override "
                        "/ device): a group syncs through one member, so these must match."
                    )
                if not _concrete_states_equal(ms[0], m):
                    raise MetricsTPUUserError(
                        f"compute_groups override groups {keys}, but the current states of {keys[0]!r} "
                        f"and {k!r} differ: group members must start from identical (e.g. freshly "
                        "reset) state."
                    )
            self._link_group(list(zip(keys, ms)))

    def _link_group(self, sg: List[Tuple[str, Metric]]) -> None:
        group = _ComputeGroup([m for _, m in sg])
        for m in group.members:
            object.__setattr__(m, "_compute_group", group)
        self._relink_group(group)
        if journal.ACTIVE:
            journal.record(
                "group.form", label=type(group.members[0]).__name__,
                members=len(group.members), keys=",".join(k for k, _ in sg),
            )

    def _relink_group(self, group: _ComputeGroup, source: Optional[Metric] = None) -> None:
        """Point every member's states at ``source``'s objects (no copies) and
        copy the family's declared update side-effect attributes."""
        if not group.members:
            return
        source = group.members[0] if source is None else source
        # the shared objects pass as they are (a relink hands nothing out);
        # when they are a compiled program's buffers, every member holds the
        # latch that makes its next read take copies
        shared = source._raw_state()
        latched = source.__dict__.get("_donation_ready", False)
        for m in group.members:
            if m is source:
                continue
            for name, v in shared.items():
                _set_state(m, name, v)
            object.__setattr__(m, "_donation_ready", latched)
            for attr in type(m)._group_shared_attrs:
                if hasattr(source, attr):
                    setattr(m, attr, getattr(source, attr))

    def _relink_groups(self) -> None:
        for group in self._iter_group_objects():
            self._relink_group(group)

    def _dissolve_groups(self) -> None:
        """Unlink every group. Former siblings would go on sharing their
        state objects, which ``forward`` and list states write in place, so
        all but the first take copies; a re-planned group links again."""
        for group in list(self._iter_group_objects()):
            for i, m in enumerate(group.members):
                object.__setattr__(m, "_compute_group", None)
                if i:
                    for k, v in m._state.items():
                        nn.Module.__setattr__(m, k, _fresh_state_value(v))
            group.members.clear()

    def _break_group(self, group: _ComputeGroup) -> None:
        """Disband a group whose dispatch raised mid-mutation: every member
        takes a copy of the state it sees and leaves, as ungrouped members
        would stand after the same failure (the member that was updating
        keeps its partial state, the others their accumulation). The groups
        are planned again at the next dispatch."""
        members = list(group.members)
        group.members.clear()
        for m in members:
            object.__setattr__(m, "_compute_group", None)
            for k, v in m._state.items():
                nn.Module.__setattr__(m, k, _fresh_state_value(v))
        if journal.ACTIVE:
            journal.record("group.detach", label="MetricCollection", members=len(members), reason="dispatch-failure")
        plan_mod.plan_invalidate(self, "group-dispatch-failure", groups_stale=True)

    # ---------------- forward / update / compute ----------------

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Each member's ``forward`` (one per compute group): accumulate, and
        return the batch values."""
        self._ensure_groups()
        out: Dict[str, Any] = {}
        group_values: Dict[int, Dict[int, Any]] = {}
        for k, m in super().items():
            g = m._compute_group
            if g is None:
                out[self._set_name(k)] = m(*args, **m._filtered_kwargs(kwargs))
            else:
                if id(g) not in group_values:
                    group_values[id(g)] = self._group_forward(g, m, args, kwargs)
                out[self._set_name(k)] = group_values[id(g)][id(m)]
        _fire_checkpointer(self)
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Each member's ``update`` (one per compute group); after the warm-up
        the eligible units update in one compiled program."""
        self._ensure_groups()
        handled = self._maybe_compiled_collection_update(args, kwargs)
        for m in self.values():
            if id(m) in handled:
                continue
            g = m._compute_group
            if g is None:
                m.update(*args, **m._filtered_kwargs(kwargs))
            else:
                handled.update(id(p) for p in g.members)
                self._group_update(g, m, args, kwargs)
        _fire_checkpointer(self)

    def _group_update(self, group: _ComputeGroup, source: Metric, args: Tuple, kwargs: Dict[str, Any]) -> None:
        """One update for the whole group: ``source`` (the group's first
        member in collection order) runs it, the others re-link to it."""
        if any(p._is_synced for p in group.members if p is not source):
            raise MetricsTPUUserError(
                "The Metric shouldn't be synced when performing ``update``. "
                "HINT: Did you forget to call ``unsync``?"
            )
        group.dispatching = True
        try:
            source.update(*args, **source._filtered_kwargs(kwargs))
        except BaseException:
            # failed mid-mutation: no later re-link may copy the partial state
            group.dispatching = False
            self._break_group(group)
            raise
        group.dispatching = False
        for p in group.members:
            if p is not source:
                p._computed = None
                p._update_called = True
                p._update_count = source._update_count
        self._relink_group(group, source)
        # a sibling's accumulation advanced too (the source's own
        # checkpointer fired inside its update)
        for p in group.members:
            if p is not source:
                _fire_checkpointer(p)

    def _group_forward(
        self, group: _ComputeGroup, source: Metric, args: Tuple, kwargs: Dict[str, Any]
    ) -> Dict[int, Any]:
        """The group's ``forward``: one update on a fresh batch state, every
        member's batch value from it, then one merge into the shared
        accumulation (in place, as ``Metric.forward``). Returns
        ``{id(member): batch value}``."""
        if any(p._is_synced for p in group.members):
            raise MetricsTPUUserError(
                "The Metric shouldn't be synced when performing ``update``. "
                "HINT: Did you forget to call ``unsync``?"
            )
        if all(not p.compute_on_step for p in group.members):
            self._group_update(group, source, args, kwargs)
            return {id(p): None for p in group.members}
        grad = any(p._forward_needs_grad(args, kwargs) for p in group.members)
        compiled = None if grad else self._maybe_compiled_group_forward(group, source, args, kwargs)
        if compiled is not None:
            return compiled
        accumulated = source._state
        # no checkpointer fires off the batch state; every member's fires below
        object.__setattr__(source, "_ckpt_suppress", True)
        try:
            source._restore(source._batch_default_state())
            group.dispatching = True
            try:
                source.update(*args, **source._filtered_kwargs(kwargs))
            finally:
                group.dispatching = False
            for p in group.members:
                if p is not source:
                    p._update_called = True
                    p._computed = None
            self._relink_group(group, source)  # the members see the batch state
            values: Dict[int, Any] = {}
            for p in group.members:
                if not p.compute_on_step:
                    values[id(p)] = None
                    continue
                p._to_sync = p.dist_sync_on_step
                p._computed = None
                try:
                    p._forward_cache = p.compute()
                finally:
                    p._to_sync = True
                p._computed = None
                values[id(p)] = p._forward_cache
            batch_state = source._state
            if source._can_merge():
                if type(source).merge_states is Metric.merge_states:
                    merged = source._merge_states(accumulated, batch_state, in_place=True)
                else:
                    merged = source.merge_states(accumulated, batch_state)
                source._restore(merged)
            else:
                # no algebraic merge: the reference's double update
                source._restore(accumulated)
                group.dispatching = True
                try:
                    source.update(*args, **source._filtered_kwargs(kwargs))
                finally:
                    group.dispatching = False
        except BaseException:
            self._break_group(group)
            raise
        finally:
            object.__setattr__(source, "_ckpt_suppress", False)
        for p in group.members:
            if p is not source:
                p._update_count = source._update_count
        self._relink_group(group, source)
        for p in group.members:
            _fire_checkpointer(p)
        return values

    def compute(self) -> Dict[str, Any]:
        """Every member's value. In a distributed run the collection syncs
        once, through the fused path, and the members compute from the
        synced state; otherwise each member syncs itself. With a collection
        round in flight, or ``sync_mode="overlap"``, the one sync resolves
        (and launches) the collection's round."""
        overlap_auto = self.sync_mode == "overlap"
        if self.__dict__.get("_inflight_round") is not None or (overlap_auto and self._overlap_eligible(None)):
            self.sync()
            try:
                return {self._set_name(k): self._compute_member(m) for k, m in super().items()}
            finally:
                self.unsync()
        if all(m._computed is not None for m in self.values()) or not self._fused_sync_eligible(None):
            # every value cached (no update since the last compute) needs no
            # sync, as each member's own compute() would not sync either
            return {self._set_name(k): m.compute() for k, m in super().items()}
        self.sync()
        try:
            return {self._set_name(k): self._compute_member(m) for k, m in super().items()}
        finally:
            self.unsync()

    @staticmethod
    def _compute_member(m: Metric) -> Any:
        if m._is_synced:
            return m.compute()
        # the collection's sync degraded to this member's local state: it
        # must not sync again on its own
        m._to_sync = False
        try:
            return m.compute()
        finally:
            m._to_sync = True

    def reset(self) -> None:
        """Reset every member; the groups are planned again at the next
        dispatch, so members that detached may rejoin. An in-flight
        collection round is drained first, on every rank alike."""
        round_, _owners, _counts = self._clear_inflight()
        if round_ is not None:
            drain_round(round_)
            registry_of(self).domain("sync")["cancelled"] += 1
        groups = list(self._iter_group_objects())
        for g in groups:
            g.dispatching = True
        try:
            for m in self.values():
                m.reset()
        finally:
            for g in groups:
                g.dispatching = False
                self._relink_group(g)
        plan_mod.plan_invalidate(self, "reset", groups_stale=True)

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "MetricCollection":
        # a move or cast of the whole collection is not a stray mutation of
        # one member: the groups stay, re-linked onto the moved states
        groups = list(self._iter_group_objects())
        for g in groups:
            g.dispatching = True
        b = plan_mod.peek_binding(self)
        if b is not None:
            b.programs.clear()  # they read the members' buffers by address
        try:
            return super()._apply(fn, *args, **kwargs)
        finally:
            for g in groups:
                g.dispatching = False
                self._relink_group(g)

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """Deep copy (compute groups included), optionally with a new
        prefix/postfix."""
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self.values():
            m.persistent(mode)

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = False) -> None:  # type: ignore[override]
        """Per-member load of a ``state_dict()`` snapshot (keys
        ``"<member>.<state>"``; grouped members each write the shared state
        under their own key). Members leave their groups while loading; the
        groups are planned again at the next dispatch, from the loaded states.

        With ``strict=True`` the snapshot must cover every member's every
        declared state and carry no other key, or a
        :class:`StateDictMismatchError` is raised before any member changes.
        """
        if strict:
            declared = {f"{k}.{name}" for k, m in super().items() for name in m._defaults}
            missing = sorted(declared - set(state_dict))
            unexpected = sorted(set(state_dict) - declared)
            if missing or unexpected:
                raise StateDictMismatchError(
                    "load_state_dict(strict=True) for MetricCollection: "
                    f"missing keys {missing}, unexpected keys {unexpected}. "
                    "Nothing was loaded."
                )
        for k, m in super().items():
            m.load_state_dict(state_dict, prefix=f"{k}.")
        plan_mod.plan_invalidate(self, "load-state-dict", schema_changed=True)

    def checkpointer(
        self,
        directory: str,
        *,
        every_n_updates: int = 1,
        keep_last: Optional[int] = None,
        rank: Optional[int] = None,
        world: Optional[int] = None,
    ) -> Any:
        """Context manager: periodic preemption-safe snapshots from
        ``update``/``forward``, the collection-level analogue of
        :meth:`Metric.checkpointer`. Grouped members snapshot one state per
        compute group (siblings are recorded as aliases and re-link on
        restore)."""
        from metrics_tpu_torch.core.checkpoint import MetricCheckpointer

        return MetricCheckpointer(
            self, directory, every_n_updates=every_n_updates, keep_last=keep_last, rank=rank, world=world
        )

    # ---------------- pure state API ----------------

    def init_state(self) -> Dict[str, Dict[str, Any]]:
        """Every member's fresh state, keyed by member (distinct storage)."""
        return {k: m.init_state() for k, m in super().items()}

    def _map_members_deduped(self, fn: Callable[[str, Metric], Any]) -> Dict[str, Any]:
        """``fn(key, member)`` per member, once per compute group: the group's
        first member runs it and every sibling key gets that result."""
        self._ensure_groups()
        out: Dict[str, Any] = {}
        group_results: Dict[int, Any] = {}
        for k, m in super().items():
            g = m._compute_group
            if g is not None and id(g) in group_results:
                out[k] = group_results[id(g)]
                continue
            result = fn(k, m)
            if g is not None:
                group_results[id(g)] = result
            out[k] = result
        return out

    def pure_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Functional update of every member's state, one update per compute
        group (a group reads its first member's subtree; thread the whole
        state through the collection's ``pure_*`` methods)."""
        return self._map_members_deduped(lambda k, m: m.pure_update(state[k], *args, **m._filtered_kwargs(kwargs)))

    def pure_compute(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return {self._set_name(k): m.pure_compute(state[k]) for k, m in super().items()}

    def merge_states(self, a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        return self._map_members_deduped(lambda k, m: m.merge_states(a[k], b[k]))

    def pure_sync(self, state: Dict[str, Any], axis_name: Optional[Any] = None, fused: bool = False) -> Dict[str, Any]:
        """In-program sync of the members' states over ``axis_name`` (see
        :meth:`Metric.pure_sync`). With no axis each member syncs over its
        own ``process_group`` and members without one keep their local
        state; raises when no member has one. One sync per compute group."""
        if axis_name is None and all(m.process_group is None for m in super().values()):
            raise MetricsTPUUserError(
                "pure_sync needs a mesh axis or process group: pass `axis_name=` or construct at least one "
                "member with `process_group=<group>`."
            )

        def sync_one(k: str, m: Metric) -> Any:
            if axis_name is not None:
                return m.pure_sync(state[k], axis_name, fused=fused)
            if m.process_group is not None:
                return m.pure_sync(state[k], fused=fused)
            return state[k]

        return self._map_members_deduped(sync_one)

    def pure_forward(
        self, state: Dict[str, Any], *args: Any, axis_name: Optional[Any] = None, **kwargs: Any
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """One functional step for the whole collection: ``(new_state, batch
        values)``. The batch values sync over ``axis_name``, or with none
        each member's over its own ``process_group`` (members without one
        stay local), as each member's own ``pure_forward`` would."""
        batch = self.pure_update(self.init_state(), *args, **kwargs)
        if axis_name is not None or any(m.process_group is not None for m in super().values()):
            value_state = self.pure_sync(batch, axis_name)
        else:
            value_state = batch
        return self.merge_states(state, batch), self.pure_compute(value_state)

    def compiled_step(
        self, state: Dict[str, Any], *args: Any, axis_name: Optional[Any] = None, **kwargs: Any
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The whole collection step as one program: every member's update
        (one per compute group), one fused in-program sync over
        ``axis_name`` when given, every member's compute. Returns
        ``(new_state, values)``; thread ``new_state`` back in. See
        :meth:`Metric.compiled_step` and ``core/plan.py::compiled_step``."""
        return plan_mod.compiled_step(self, state, args, kwargs, axis_name=axis_name)

    # ---------------- compiled hot path ----------------

    def _compiled_dispatcher(self) -> CompiledDispatcher:
        disp = self.__dict__.get("_compiled")
        if disp is None:
            disp = CompiledDispatcher("MetricCollection", registry_of(self).domain("compile"), plan_mod.binding(self))
            self.__dict__["_compiled"] = disp
        return disp

    def __getstate__(self) -> Dict[str, Any]:
        # pickle and deepcopy: an in-flight round's future cannot be copied,
        # so drain it first (the fold-back keeps every accumulation)
        self._cancel_overlap()
        state = dict(self.__dict__)
        for key in ("_compiled", "_plan_binding"):
            state.pop(key, None)
        reg = state.get("_telemetry")
        if reg is not None:
            state["_telemetry"] = reg.with_fresh_domain("compile")
        return state

    def _compiled_units(self) -> List[Tuple[str, Metric, Tuple[Metric, ...]]]:
        """One ``(key, leader, members)`` per dispatch unit: solo members
        stand alone, compute groups dispatch through their first member."""
        units: List[Tuple[str, Metric, Tuple[Metric, ...]]] = []
        seen: set = set()
        for k, m in super().items():
            g = m._compute_group
            if g is None:
                units.append((k, m, (m,)))
            elif id(g) not in seen:
                seen.add(id(g))
                units.append((k, m, tuple(g.members)))
        return units

    def _maybe_compiled_collection_update(self, args: Tuple, kwargs: Dict[str, Any]) -> set:
        """Every compiled-eligible unit's update in ONE program. Returns the
        ids of the members it handled (empty when nothing ran). With fewer
        than two eligible units the members' own compiled paths serve; a
        member that falls back stays on the eager loop and the program
        shrinks around it."""
        if not compiled_update_enabled():
            return set()
        eligible: List[Tuple[str, Metric, Tuple[Metric, ...]]] = []
        force = False
        for k, m, members in self._compiled_units():
            knob = m.compiled_update
            if knob is False:
                continue
            disp = m._compiled_dispatcher()
            if "update" in disp.fallback or not m._compiled_static_ok("update", disp):
                continue
            force = force or knob is True
            eligible.append((k, m, members))
        if len(eligible) < 2:
            return set()
        coll_disp = self._compiled_dispatcher()
        coll_disp.steps_seen += 1
        if "update" in coll_disp.fallback:
            return set()
        if not force and coll_disp.steps_seen <= compiled_warmup():
            return set()
        if coll_disp.storming("update"):
            return set()
        try:
            treedef, dyn_ix, statics, dynamic = split_call(args, kwargs)
        except TypeError:
            coll_disp.mark_fallback("update", "update arguments contain unhashable non-array values")
            return set()
        sigs = []
        for _k, m, _members in eligible:
            sig = state_signature(m._raw_state())
            if sig is None or any(t.device != m.device for t in dynamic) or any(map(_is_weak, m._raw_state().values())):
                return set()  # a state or an input no program owns: eager this step
            sigs.append(sig)
        skeleton = (treedef, dyn_ix, statics)
        pairs = [(k, m) for k, m, _ in eligible]
        key = ("update", tuple(k for k, _ in pairs), treedef, dyn_ix, statics)

        def fn(states: Dict[str, Any], dyn: List[torch.Tensor]) -> Tuple[Dict[str, Any], Any]:
            a, kw = rebuild_call(*skeleton, dyn)
            return {k: m.pure_update(states[k], *a, **m._filtered_kwargs(kw)) for k, m in pairs}, None

        if not coll_disp.probed(key):
            # the static verdict, member by member: a refuted member falls
            # back on its own; an all-clean roster skips the probe
            verdicts = [consult_static([(m, ("update",))]) for _k, m in pairs]
            for (_k, m), (verdict, detail) in zip(pairs, verdicts):
                if verdict == "dirty":
                    m._compiled_dispatcher().mark_fallback("update", detail)
            if any(v == "dirty" for v, _ in verdicts):
                return set()
            if all(v == "clean" for v, _ in verdicts):
                coll_disp.mark_probed(key)
        if not coll_disp.probed(key):
            reason = probe_traceable(fn, {k: m._raw_state() for k, m in pairs}, dynamic, [m for _, m in pairs])
            if reason is not None:
                # attribute the failure: each unit alone, so one untraceable
                # member marks only itself and the rest fuse again next step
                culprits = 0
                for k, m in pairs:

                    def solo(state: Dict[str, Any], dyn: List[torch.Tensor], _m: Metric = m) -> Any:
                        a, kw = rebuild_call(*skeleton, dyn)
                        return _m.pure_update(state, *a, **_m._filtered_kwargs(kw))

                    solo_reason = probe_traceable(solo, m._raw_state(), dynamic, [m])
                    if solo_reason is not None:
                        m._compiled_dispatcher().mark_fallback("update", solo_reason)
                        culprits += 1
                if culprits == 0:
                    coll_disp.mark_fallback("update", reason)
                return set()
            coll_disp.mark_probed(key)
        if any(p._is_synced for _, _, members in eligible for p in members):
            raise MetricsTPUUserError(
                "The Metric shouldn't be synced when performing ``update``. "
                "HINT: Did you forget to call ``unsync``?"
            )
        slots: Dict[str, Dict[str, Any]] = {}
        for (k, m, _), sig in zip(eligible, sigs):
            slots[k] = m._compiled_dispatcher().slot(sig, m._raw_state())
            m._state_in(slots[k])
        device = eligible[0][1].device
        pkey = key + (tensor_signature(dynamic), tuple(sigs), tuple(m._dtype for _, m, _ in eligible))
        try:
            prog = coll_disp.program(
                pkey,
                lambda: Program.build(fn, slots, [(slots[k], k) for k, _ in pairs], dynamic, device, coll_disp.pool(device)),
            )
        except CaptureError as err:
            coll_disp.mark_fallback("update", f"compiled dispatch failed ({err})")
            return set()
        if prog is None:
            return set()
        dispatch_program(coll_disp, "update", prog, dynamic)
        handled: set = set()
        for k, m, members in eligible:
            m._bind_slot(prog.slots[k])
            try:
                _raise_on_catbuffer_overflow(prog.slots[k], type(m).__name__)
            except MetricsTPUUserError:
                if m._compute_group is not None:
                    self._break_group(m._compute_group)
                raise
            m._update_count += 1
            m._update_called = True
            m._computed = None
            for p in members:
                handled.add(id(p))
                if p is m:
                    continue
                p._computed = None
                p._update_called = True
                p._update_count = m._update_count
            g = m._compute_group
            if g is not None:
                self._relink_group(g, m)
            for p in members:
                _fire_checkpointer(p)
        return handled

    def _maybe_compiled_group_forward(
        self, group: _ComputeGroup, source: Metric, args: Tuple, kwargs: Dict[str, Any]
    ) -> Optional[Dict[int, Any]]:
        """A compute group's ``forward`` as ONE program: the group's update on
        a fresh batch state, every member's batch compute, the merge into the
        shared accumulation. Returns ``{id(member): batch value}``, or ``None``
        for the eager path."""
        knob = source.compiled_update
        if knob is False or not compiled_update_enabled():
            return None
        members = list(group.members)
        if any(p.compiled_update is False for p in members):
            return None
        if any(p.dist_sync_on_step or p.check_finite for p in members):
            return None
        disp = source._compiled_dispatcher()
        if "forward" in disp.fallback:
            return None
        if knob is not True and disp.steps_seen <= compiled_warmup():
            return None
        if not source._compiled_static_ok("forward", disp):
            return None
        coll_disp = self._compiled_dispatcher()
        member_keys = tuple(k for k, m in super().items() if m in members)
        fkind = "forward[" + ",".join(member_keys) + "]"
        if fkind in coll_disp.fallback:
            return None
        if coll_disp.storming(fkind):
            return None
        inputs = source._program_inputs(coll_disp, args, source._filtered_kwargs(kwargs), fkind)
        if inputs is None:
            return None
        skey, dynamic, sig = inputs
        skeleton = skey[1:]
        key = (fkind,) + skeleton
        on_step = [p for p in members if p.compute_on_step]
        # forward's update precedes the batch computes (as in eager, where
        # the inner update marks every member updated)
        for p in members:
            p._update_called = True

        def fn(state: Dict[str, Any], dyn: List[torch.Tensor]) -> Tuple[Dict[str, Any], Any]:
            a, kw = rebuild_call(*skeleton, dyn)
            batch = source.pure_update(source._batch_default_state(), *a, **kw)
            values = tuple(p.pure_compute(batch) for p in on_step)
            return source._forward_merge(state, batch), values

        if not coll_disp.probed(key):
            verdict, detail = consult_static([(source, ("update", "merge"))] + [(p, ("compute",)) for p in on_step])
            if verdict == "dirty":
                coll_disp.mark_fallback(fkind, detail)
                return None
            if verdict != "clean":
                reason = probe_traceable(fn, source._raw_state(), dynamic, members)
                if reason is not None:
                    coll_disp.mark_fallback(fkind, reason)
                    return None
            coll_disp.mark_probed(key)
        slot = disp.slot(sig, source._raw_state())
        source._state_in(slot)
        device = source.device
        pkey = key + (tensor_signature(dynamic), sig, source._dtype)
        try:
            prog = coll_disp.program(
                pkey, lambda: Program.build(fn, slot, [(slot, None)], dynamic, device, coll_disp.pool(device)))
        except CaptureError as err:
            coll_disp.mark_fallback(fkind, f"compiled dispatch failed ({err})")
            return None
        if prog is None:
            return None
        values = dispatch_program(coll_disp, fkind, prog, dynamic)
        source._bind_slot(slot)
        try:
            _raise_on_catbuffer_overflow(slot, type(source).__name__)
        except MetricsTPUUserError:
            self._break_group(group)
            raise
        source._update_count += 1
        for p in members:
            p._update_called = True
            p._computed = None
            p._update_count = source._update_count
        self._relink_group(group, source)
        out: Dict[int, Any] = {}
        values_it = iter(values)
        for p in members:
            if p.compute_on_step:
                p._forward_cache = next(values_it)
                out[id(p)] = p._forward_cache
            else:
                out[id(p)] = None
        for p in members:
            _fire_checkpointer(p)
        return out

    # ---------------- telemetry ----------------

    def compile_stats(self) -> Dict[str, Any]:
        """``{"collection": {...}, "members": {key: {...}}}``: the compile
        domains of the collection and of each member (see
        :meth:`Metric.compile_stats`)."""
        coll = compile_stats_view(registry_of(self).domain("compile"))
        return {"collection": coll, "members": {k: m.compile_stats() for k, m in super().items()}}

    def sync_stats(self) -> Dict[str, Any]:
        """``{"collection": {...}, "members": {key: {...}}}``: the sync
        domains of the collection (its combined rounds) and of each member
        (see :meth:`Metric.sync_stats`)."""
        coll = dict(registry_of(self).domain("sync"))
        return {"collection": coll, "members": {k: m.sync_stats() for k, m in super().items()}}

    def telemetry(self, delta: bool = False) -> Dict[str, Any]:
        """The snapshot of the collection and of every member:
        ``{"collection": {schema, label, compile, sync, checkpoint, health,
        plan, process}, "members": {key: <member telemetry>}}`` (see
        :meth:`Metric.telemetry`; ``delta=True`` on every registry)."""
        reg = registry_of(self)
        extra = {"compile": compile_stats_view(reg.domain("compile"))}
        coll = reg.delta(extra) if delta else reg.snapshot(extra)
        return {"collection": coll, "members": {k: m.telemetry(delta=delta) for k, m in super().items()}}

    # ---------------- host sync ----------------

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
        on_error: Optional[str] = None,
        on_missing: Optional[str] = None,
        timeout: Optional[float] = None,
        blocking: Optional[bool] = None,
    ) -> None:
        """Sync every member.

        The default is the fused path: every member's state (one per compute
        group) in one key-prefixed dict, through one health header and one
        bucketed plan. It raises before any member changes. When it fails
        and some member would degrade (``on_error`` of ``"local"`` or
        ``"warn"``, or ``on_missing="local"`` and a missing-rank failure),
        every member syncs on its own instead and applies its own policy;
        the outcome of the header is the same on every rank, so all ranks
        fall back together. A member with a custom ``dist_sync_fn``, another
        process group than the first member's, ``sync_fused=False`` or
        strict update counts, or ``METRICS_TPU_FUSED_SYNC=0``, makes every
        member sync on its own. That loop syncs every member, group siblings
        included, so its collectives do not depend on the groups; if a
        member raises, those already synced are restored first.

        ``blocking=False`` (the default under ``sync_mode="overlap"``)
        launches ONE collection round over the combined payload instead
        (``parallel/async_sync.py``): every member restarts on fresh delta
        state, and the next ``sync()``/``compute()``/``state_dict()`` (a
        member's too) resolves the round and applies it to every member, all
        or nothing. A failed resolve degrades as a failed fused sync does:
        all members under ``"raise"`` raise, with every local accumulation
        restored first; otherwise the per-member blocking loop runs again.
        A collection that cannot overlap (see the conditions above, or
        state with no merge) warns once and syncs blocking.
        """
        if on_error is not None:
            _check_on_error(on_error)
        if on_missing is not None:
            for m in self.values():
                _sync.check_on_missing(on_missing, m.process_group)
        self._ensure_groups()
        overlap_auto = self.sync_mode == "overlap"
        if blocking is None:
            blocking = not overlap_auto
        failed_resolve = False
        if should_sync and self.__dict__.get("_inflight_round") is not None:
            try:
                self._resolve_overlap(on_error=on_error, timeout=timeout, relaunch=not blocking,
                                      on_missing=on_missing)
                return
            except SyncError as err:
                if not self._sync_failure_degrades(err, on_error, on_missing, "resolve"):
                    raise  # every member's local accumulation was restored first
                # some member degrades: every member holds its local state
                # again, and the per-member blocking loop applies its policy
                failed_resolve, blocking = True, True
        if should_sync and not blocking and dist_sync_fn is None:
            if self._overlap_eligible(distributed_available):
                self._launch_overlap(timeout=timeout, serve_local=overlap_auto, on_missing=on_missing)
                return
            if not self.__dict__.get("_overlap_warned", False):
                self._overlap_warned = True
                rank_zero_warn(
                    "MetricCollection cannot overlap its sync (a member has a custom dist_sync_fn or another "
                    "process group, state with no merge or strict update counts, or the fused path is "
                    "disabled): falling back to the blocking path.",
                    UserWarning,
                )
            blocking = True
        if should_sync and dist_sync_fn is None and self._fused_sync_eligible(distributed_available):
            try:
                self._sync_fused(timeout=timeout, on_missing=on_missing)
                return
            except SyncError as err:
                if not self._sync_failure_degrades(err, on_error, on_missing, "fused"):
                    raise  # nothing was synced: all-or-nothing holds
        synced: List[Metric] = []
        try:
            for m in self.values():
                m.sync(
                    dist_sync_fn=dist_sync_fn,
                    should_sync=should_sync,
                    distributed_available=distributed_available,
                    on_error=on_error,
                    on_missing=on_missing,
                    timeout=timeout,
                    blocking=blocking,
                )
                if m._is_synced:
                    synced.append(m)
        except Exception:
            for m in synced:
                m.unsync()
            raise
        if failed_resolve and any(m._sync_degraded for m in self.values()):
            # a rerun that recovered every member is no degradation
            registry_of(self).domain("sync")["degraded"] += 1

    def _sync_failure_degrades(self, err: SyncError, on_error: Optional[str], on_missing: Optional[str],
                               phase: str) -> bool:
        """Count a failed combined sync; does some member degrade it?"""
        modes = [m.sync_on_error if on_error is None else on_error for m in self.values()]
        degrades = not all(mode == "raise" for mode in modes) or self._missing_degrades(err, on_missing)
        registry_of(self).count_error(err, degraded=degrades)
        if journal.ACTIVE:
            journal.record("health.failure", label="MetricCollection", error=type(err).__name__, phase=phase)
        return degrades

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore every synced member's local state (members whose sync
        degraded are skipped) and re-link the groups. A collection round
        launched and not resolved is cancelled: drained on every rank, its
        result discarded, every member's snapshot folded back."""
        if not should_unsync:
            return
        if self.__dict__.get("_inflight_round") is not None and not any(m._is_synced for m in self.values()):
            self._cancel_overlap()
            return
        for m in self.values():
            if m._is_synced:
                m.unsync()
        self._relink_groups()

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
        on_error: Optional[str] = None,
        on_missing: Optional[str] = None,
        timeout: Optional[float] = None,
        blocking: Optional[bool] = None,
    ) -> Iterator["MetricCollection"]:
        """Sync on enter, restore the local states on exit."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            should_sync=should_sync,
            distributed_available=distributed_available,
            on_error=on_error,
            on_missing=on_missing,
            timeout=timeout,
            blocking=blocking,
        )
        try:
            yield self
        finally:
            self.unsync(should_unsync=should_unsync)

    def _missing_degrades(self, err: SyncError, on_missing: Optional[str]) -> bool:
        """Does an ``on_missing="local"`` policy (the override, or some
        member's) degrade this missing-rank failure?"""
        if not is_missing_rank_error(err):
            return False
        return any((m.sync_on_missing if on_missing is None else on_missing) == "local" for m in self.values())

    def _effective_on_missing(self, on_missing: Optional[str]) -> str:
        """The policy of a combined sync: the override, else the members'
        common ``sync_on_missing``, else ``"raise"``."""
        if on_missing is not None:
            return on_missing
        modes = {m.sync_on_missing for m in self.values()}
        return modes.pop() if len(modes) == 1 else "raise"

    def _effective_member_timeout(self, timeout: Optional[float]) -> Optional[float]:
        member_timeouts = [m.sync_timeout for m in self.values() if m.sync_timeout is not None]
        if timeout is not None:
            return timeout
        return min(member_timeouts) if member_timeouts else None

    def _fused_sync_eligible(self, distributed_available: Optional[Callable]) -> bool:
        """Can the collection sync through one combined plan? Every member on
        the built-in transport over one process group, none synced already
        or covered by a round of its own, none strict about update counts
        (the combined header carries one summed count), the fused knob on,
        and a distributed world."""
        members = list(self.values())
        if not members or not bucketing.fused_sync_enabled():
            return False
        group = members[0].process_group
        if any(
            m.dist_sync_fn is not None
            or m.process_group is not group
            or m._is_synced
            or m.__dict__.get("_inflight") is not None
            or m.sync_fused is False
            or m.sync_strict_update_count
            for m in members
        ):
            return False
        if any(FUSED_KEY_SEP in key for key in self.keys()):
            return False
        return all((distributed_available or m._distributed_available)() for m in members)

    def _combined_payload(
        self, owners: List[Tuple[str, Metric, List[Metric]]], state_of: Callable[[Metric], Dict[str, Any]]
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The key-prefixed combined state and reductions of the owners (one
        definition for the blocking fused sync and the overlapped rounds)."""
        combined: Dict[str, Any] = {}
        reductions: Dict[str, Any] = {}
        for key, m, _peers in owners:
            for name, value in state_of(m).items():
                combined[f"{key}{FUSED_KEY_SEP}{name}"] = value
                reductions[f"{key}{FUSED_KEY_SEP}{name}"] = m._reductions.get(name)
        return combined, reductions

    def _sync_state_owners(self) -> List[Tuple[str, Metric, List[Metric]]]:
        """One ``(key, metric, group siblings)`` per unique state: a compute
        group contributes its state once."""
        owners: List[Tuple[str, Metric, List[Metric]]] = []
        seen: set = set()
        for key, m in super().items():
            g = m._compute_group
            if g is None:
                owners.append((key, m, []))
            elif id(g) not in seen:
                seen.add(id(g))
                owners.append((key, m, [p for p in g.members if p is not m]))
        return owners

    def _sync_fused(self, timeout: Optional[float] = None, on_missing: Optional[str] = None) -> None:
        """One header and one bucketed plan over every unique member state.
        The header's ``update_count`` is the sum over the owners (which is
        why strict members take the per-member loop). Raises before any
        member changes."""
        owners = self._sync_state_owners()
        combined, reductions = self._combined_payload(owners, lambda m: m._state)
        # the combined schema's plan build or hit counts for the collection
        plan_mod.plan_for(combined, reductions, owner=self)
        members = list(self.values())
        synced = _sync.host_sync_state(
            combined,
            reductions,
            members[0].process_group,
            update_count=sum(m._update_count for _, m, _p in owners),
            timeout=self._effective_member_timeout(timeout),
            metric_name=f"MetricCollection[{', '.join(self.keys())}]",
            fused=True,
            on_missing=self._effective_on_missing(on_missing),
            stats=registry_of(self).domain("sync"),
            sync_precision=self.sync_precision,
        )
        for key, m, peers in owners:
            m._cache = m._state
            m._sync_degraded = False
            m._restore({name: synced[f"{key}{FUSED_KEY_SEP}{name}"] for name in m._defaults})
            m._is_synced = True
            for p in peers:
                p._cache = dict(m._cache)
                p._sync_degraded = False
                for name in m._defaults:
                    nn.Module.__setattr__(p, name, getattr(m, name))
                p._is_synced = True

    # ---------------- overlapped (non-blocking) collection sync ----------------

    def _overlap_eligible(self, distributed_available: Optional[Callable]) -> bool:
        """Can the collection launch one combined round? The fused-path
        conditions, every member's state mergeable, no round in flight."""
        if self.__dict__.get("_inflight_round") is not None:
            return False
        if not self._fused_sync_eligible(distributed_available):
            return False
        return all(m._overlap_refusal() is None for m in self.values())

    def _launch_combined(
        self,
        owners: List[Tuple[str, Metric, List[Metric]]],
        state_of: Callable[[Metric], Dict[str, Any]],
        timeout: Optional[float],
        on_missing: Optional[str] = None,
    ) -> None:
        """The one launch of a collection round: the combined payload of
        ``state_of(owner)`` (the live state, or the unsync cache on a
        pipeline relaunch), launched, and the in-flight bookkeeping."""
        combined, reductions = self._combined_payload(owners, state_of)
        counts = {key: m._update_count for key, m, _peers in owners}
        plan_mod.plan_for(combined, reductions, owner=self)
        plan_mod.next_sync_epoch(self)
        round_ = launch_round(
            combined,
            reductions,
            update_count=sum(counts.values()),
            epoch=self._sync_epoch,
            metric_name=f"MetricCollection[{', '.join(self.keys())}]",
            group=next(iter(self.values())).process_group,
            timeout=self._effective_member_timeout(timeout),
            fused=True,
            on_missing=self._effective_on_missing(on_missing),
            stats=registry_of(self).domain("sync"),
            sync_precision=self.sync_precision,
        )
        self._inflight_round = round_
        self._inflight_owners = owners
        self._inflight_counts = counts
        for m in self.values():
            object.__setattr__(m, "_inflight_collection", self)
        registry_of(self).domain("sync")["launched"] += 1

    def _launch_overlap(
        self, timeout: Optional[float] = None, serve_local: bool = False, on_missing: Optional[str] = None
    ) -> None:
        """Launch ONE round over the combined (one per group) member states
        and restart every member on fresh delta state. ``serve_local`` (the
        overlap pipeline's first read) serves each member its snapshot as
        this read's value, the fresh delta state waiting in its unsync
        cache."""
        owners = self._sync_state_owners()
        snapshots = {key: m._state for key, m, _peers in owners}  # the round takes these
        by_owner = {id(m): snapshots[key] for key, m, _peers in owners}
        self._launch_combined(owners, lambda m: by_owner[id(m)], timeout, on_missing=on_missing)
        for _key, m, _peers in owners:
            m._restore(m.init_state())
        self._relink_groups()
        if serve_local:
            for key, m, peers in owners:
                fresh = m._state
                for x in [m] + peers:
                    x._cache = dict(fresh)
                    x._sync_degraded = False
                    x._restore(snapshots[key])
                    x._is_synced = True
            registry_of(self).domain("sync")["served_local"] += 1

    def _clear_inflight(self):
        round_ = self.__dict__.get("_inflight_round")
        owners = self.__dict__.get("_inflight_owners")
        counts = self.__dict__.get("_inflight_counts")
        self._inflight_round = None
        self._inflight_owners = None
        self._inflight_counts = None
        for m in self.values():
            object.__setattr__(m, "_inflight_collection", None)
        return round_, owners, counts

    def _inflight_members(self, owners) -> List[Tuple[str, Metric, List[Metric]]]:
        """The launch-time owners, split for members that left their group
        while the round flew: such a member keeps its own delta and
        resolves against the same snapshot slice."""
        out: List[Tuple[str, Metric, List[Metric]]] = []
        for key, m, peers in owners:
            grouped = [p for p in peers if p._compute_group is not None and p._compute_group is m._compute_group]
            out.append((key, m, grouped))
            out.extend((key, p, []) for p in peers if p not in grouped)
        return out

    def _snapshot_slice(self, combined: Dict[str, Any], key: str, x: Metric) -> Dict[str, Any]:
        return {name: combined[f"{key}{FUSED_KEY_SEP}{name}"] for name in x._defaults}

    def _fold_back_overlap(self, combined_snapshot, owners, counts) -> None:
        """Restore every member's full local accumulation (its snapshot
        slice merged with its delta): the first step of every failure path
        of a collection round."""
        for key, x, _grouped in self._inflight_members(owners):
            snapshot = self._snapshot_slice(combined_snapshot, key, x)
            x._restore(x.merge_states(snapshot, x._state) if x._update_count > counts[key] else snapshot)
            x._cache = None
            g = x._compute_group
            if g is not None:
                self._relink_group(g, x)

    def _resolve_overlap(
        self,
        on_error: Optional[str] = None,
        timeout: Optional[float] = None,
        relaunch: bool = False,
        on_missing: Optional[str] = None,
    ) -> None:
        """Consume the collection's round and apply it to every member, all
        or nothing: every member's view and local accumulation are computed
        first, then committed. A failure (the round's typed error, or a
        stale member under ``"fresh"``) restores every member's full local
        accumulation and raises; :meth:`sync` runs the degradation.
        ``relaunch`` pipelines the next round from the restored
        accumulations."""
        round_, owners, counts = self._clear_inflight()
        stats = registry_of(self).domain("sync")
        try:
            synced, wait_s = resolve_round(round_, timeout=timeout)
        except SyncError:
            self._fold_back_overlap(round_.snapshot, owners, counts)
            raise
        stats["resolved"] += 1
        stats["gather_s"] += round_.gather_s
        stats["resolve_wait_s"] += wait_s
        stats["overlap_saved_s"] += max(0.0, round_.gather_s - wait_s)
        policy = self.staleness_policy
        members = self._inflight_members(owners)
        any_stale = any(x._update_count > counts[key] for key, x, _g in members)
        if journal.ACTIVE:
            journal.record(
                "sync.resolve", label="MetricCollection", sync_epoch=round_.epoch, stale=any_stale, policy=policy,
                verdict=("stale:" + policy) if any_stale else "fresh", wait_s=wait_s, gather_s=round_.gather_s,
                gather_start=round_.gather_started,
            )
        if any_stale:
            stats["stale_resolves"] += 1
            if policy == "fresh":
                self._fold_back_overlap(round_.snapshot, owners, counts)
                raise StaleSyncError(
                    f"overlapped sync round {round_.epoch} of this MetricCollection resolved stale: update() "
                    "ran after the snapshot was taken (staleness_policy='fresh'). Resolve before updating, or "
                    "accept bounded staleness with staleness_policy='snapshot'|'merge'."
                )
        plans = []
        for key, x, grouped in members:
            snapshot = self._snapshot_slice(round_.snapshot, key, x)
            gathered = self._snapshot_slice(synced, key, x)
            if x._update_count > counts[key]:
                delta = x._state
                local = x.merge_states(snapshot, delta)
                view = x.merge_states(gathered, delta) if policy == "merge" else gathered
            else:
                local, view = snapshot, gathered
            plans.append((x, grouped, view, local))
        for x, grouped, view, local in plans:
            x._cache = local
            x._sync_degraded = False
            x._restore(view)
            x._is_synced = True
            for p in grouped:
                p._cache = dict(local)
                p._sync_degraded = False
                for name in x._defaults:
                    nn.Module.__setattr__(p, name, getattr(x, name))
                p._is_synced = True
        if relaunch:
            self._relaunch_from_caches(timeout, on_missing=on_missing)

    def _relaunch_from_caches(self, timeout: Optional[float], on_missing: Optional[str] = None) -> None:
        """The pipeline: every member's restored accumulation (its unsync
        cache) goes to the next round; the caches get fresh delta state."""
        owners = self._sync_state_owners()
        self._launch_combined(owners, lambda m: m._cache or m._state, timeout, on_missing=on_missing)
        for _key, m, peers in owners:
            fresh = m.init_state()
            m._cache = fresh
            for p in peers:
                p._cache = dict(fresh)

    def _resolve_member_request(
        self,
        member: Metric,
        on_error: Optional[str] = None,
        on_missing: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> None:
        """One member's read (``compute()``, ``sync()``, ``state_dict()``)
        while a collection round covers its state: the whole round resolves
        and every member is left synced (restore them together with
        :meth:`unsync`)."""
        self.sync(on_error=on_error, on_missing=on_missing, timeout=timeout, blocking=True)

    def _cancel_overlap(self) -> None:
        """The symmetric cancel of a collection round (``unsync()``,
        ``reset()``, a copy): drain it on every rank, discard its result or
        its error, and fold every member's snapshot slice back."""
        round_, owners, counts = self._clear_inflight()
        if round_ is None:
            return
        drain_round(round_)
        registry_of(self).domain("sync")["cancelled"] += 1
        if any(m._is_synced for m in self.values()):
            # mid-pipeline: the drained round holds the accumulations, the
            # members serve the previous resolve; their delta caches are
            # empty (updates are refused while synced)
            for key, m, peers in owners:
                snap = self._snapshot_slice(round_.snapshot, key, m)
                for x in [m] + peers:
                    x._cache = dict(snap)
            return
        self._fold_back_overlap(round_.snapshot, owners, counts)
