"""The ``Metric`` base class: stateful batch accumulation with cross-process sync.

Counterpart of ``metrics_tpu/core/metric.py`` (the contract subset): states
declared with :meth:`Metric.add_state`, the update/compute wrappers with the
compute cache and the compute-before-update warning, ``forward`` (batch value
plus accumulation), ``sync``/``unsync``/``sync_context``, ``merge_states``,
``reset``, ``clone``, ``state_dict``/``load_state_dict``, pickling,
``set_dtype`` with its per-update persistence, the operator overloads and
:class:`CompositionalMetric`; the health-checked sync with its ``on_error`` /
``on_missing`` degradation ladder (quorum included) and watchdog timeout, the
tiered sync's ``sync_precision``, ``check_finite``
screening, and the compute-group protocol ``MetricCollection`` plans with
(``state_fingerprint``, ``update_identity``, copy-on-write detach); the
telemetry surface (``telemetry``, ``sync_stats``, ``compile_stats``, the
health counters and the journal events of a failed sync and a detach); the
overlapped sync (``sync(blocking=False)``, ``sync_mode="overlap"``,
``staleness_policy``; ``parallel/async_sync.py``); the pure state API
(``init_state``, ``pure_update``, ``pure_compute``, ``pure_sync``,
``pure_forward``), the whole-step program ``compiled_step``
(``core/plan.py``) and the compiled hot path (``core/compiled.py``), which
replays ``update``/``forward`` as a CUDA graph after a warm-up.

``Metric`` is a ``torch.nn.Module``, as upstream TorchMetrics' is: tensor
states are registered buffers (so ``.to()``/``.cuda()`` move them), list
states are plain Python lists, and ``with_capacity(n)`` turns the list states
into :class:`~metrics_tpu_torch.core.cat_buffer.CatBuffer` states, which
``_apply`` moves and casts. Tensor and list states are never written in
place by the eager path; every update assigns a new tensor, so a snapshot
(the sync cache, a forward's accumulated state) is a dict of references, not
copies. The compiled path does write in place, into static buffers its CUDA
graphs own: while a metric's states are those buffers (the donation latch is
set), any read of a state first gives the metric copies of its own, so no
tensor a caller holds ever changes under a later replay. A
CatBuffer is written in place by its ``append``; every path here that would
let two holders see one buffer hands one of them fresh storage instead
(``core/cat_buffer.py``). Members of a compute group hold the same state
objects; a member that leaves its group takes a clone of every leaf, since
``forward`` merges into its accumulation's CatBuffers in place.
"""
import functools
import inspect
import warnings
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils import _pytree as pytree

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
    in_program,
    probe_traceable,
    rebuild_call,
    split_call,
    state_signature,
    tensor_signature,
)
from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.observability.registry import registry_of
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.parallel.bucketing import fused_sync_enabled
from metrics_tpu_torch.parallel.async_sync import (
    AsyncSyncRound,
    drain_round,
    launch_round,
    resolve_round,
    validate_staleness_policy,
)
from metrics_tpu_torch.parallel.health import NONFINITE_STATE, is_missing_rank_error, state_poisoned
from metrics_tpu_torch.parallel.quantize import validate_sync_precision
from metrics_tpu_torch.utils.device import resolve_device
from metrics_tpu_torch.utils.exceptions import (
    MetricsTPUUserError,
    NonFiniteStateError,
    StaleSyncError,
    StateDictMismatchError,
    StateSchemaError,
    SyncError,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn

_MERGEABLE_FX = ("sum", "cat", "max", "min")

#: Accepted ``sync_mode`` values: ``"blocking"`` gathers inline at
#: ``sync()``/``compute()``; ``"overlap"`` double-buffers, the gather riding a
#: background lane while the step keeps updating (``parallel/async_sync.py``).
_SYNC_MODES = ("blocking", "overlap")

#: Accepted ``on_error`` / ``sync_on_error`` degradation modes.
_ON_ERROR_MODES = ("raise", "local", "warn")


def _check_on_error(on_error: str) -> str:
    if on_error not in _ON_ERROR_MODES:
        raise MetricsTPUUserError(f"`on_error` must be one of {_ON_ERROR_MODES}, got {on_error!r}")
    return on_error


# module-level named operators: picklable, unlike lambdas
def _add(a, b): return torch.add(a, b)                # noqa: E704
def _sub(a, b): return torch.sub(a, b)                # noqa: E704
def _mul(a, b): return torch.mul(a, b)                # noqa: E704
def _div(a, b): return torch.true_divide(a, b)        # noqa: E704
def _floordiv(a, b): return torch.floor_divide(a, b)  # noqa: E704
def _mod(a, b): return torch.remainder(a, b)          # noqa: E704
def _pow(a, b): return torch.pow(a, b)                # noqa: E704
def _matmul(a, b): return torch.matmul(a, b)          # noqa: E704
def _and(a, b): return torch.bitwise_and(a, b)        # noqa: E704
def _or(a, b): return torch.bitwise_or(a, b)          # noqa: E704
def _xor(a, b): return torch.bitwise_xor(a, b)        # noqa: E704
def _eq(a, b): return torch.eq(a, b)                  # noqa: E704
def _ne(a, b): return torch.ne(a, b)                  # noqa: E704
def _lt(a, b): return torch.lt(a, b)                  # noqa: E704
def _le(a, b): return torch.le(a, b)                  # noqa: E704
def _gt(a, b): return torch.gt(a, b)                  # noqa: E704
def _ge(a, b): return torch.ge(a, b)                  # noqa: E704
def _abs(x): return torch.abs(x)                      # noqa: E704
def _neg(x): return torch.neg(x)                      # noqa: E704
def _logical_not(x): return torch.logical_not(x)      # noqa: E704


def _getitem(x: Any, idx: Any) -> Any:
    return x[idx]


def _cast_floating(state: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Cast every floating tensor of a state dict (list states item by item)
    to ``dtype``; the per-update re-cast of ``set_dtype``."""

    def cast(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype) if x.is_floating_point() else x

    def cast_value(v: Any) -> Any:
        if isinstance(v, list):
            return [cast(x) for x in v]
        if isinstance(v, CatBuffer):
            # once per buffer: later appends copy into the cast buffer
            return v._apply(cast)
        return cast(v)

    return {k: cast_value(v) for k, v in state.items()}


def _tensor_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _tensor_leaves(x)]
    if isinstance(tree, dict):
        return [leaf for x in tree.values() for leaf in _tensor_leaves(x)]
    return []


def _leaf_nonfinite(x: Any) -> Optional[torch.Tensor]:
    if not isinstance(x, torch.Tensor) or not (x.is_floating_point() or x.is_complex()):
        return None
    return torch.logical_not(torch.isfinite(x).all())


def _update_nonfinite_flag(
    state: Dict[str, Any], inputs: Any, prev_list_lens: Dict[str, int], device: torch.device
) -> torch.Tensor:
    """int32 0/1 on ``device``: NaN/Inf brought in by this ``update``, with no
    host read. Screens the update's float inputs, the tensor states and the
    list entries this update appended (``prev_list_lens`` holds each list's
    length before it). CatBuffer bodies are not scanned per update (their
    rows are the screened inputs); the exact whole-state scan runs once at
    the sync and compute boundary (``parallel/health.py::state_poisoned``)."""
    bad = torch.zeros((), dtype=torch.bool, device=device)
    leaves = _tensor_leaves(inputs)
    for name, v in state.items():
        if name == NONFINITE_STATE or isinstance(v, CatBuffer):
            continue
        leaves += v[prev_list_lens.get(name, 0):] if isinstance(v, list) else [v]
    for leaf in leaves:
        b = _leaf_nonfinite(leaf)
        if b is not None:
            bad = torch.logical_or(bad, b.to(device))
    return bad.to(torch.int32)


class _ComputeGroup:
    """The link between the members of a ``MetricCollection`` compute group:
    every member's state attributes hold the same objects, so the group pays
    for one update and one copy of state. ``dispatching`` is True only while
    the collection drives a group-level operation, which tells a sanctioned
    shared-state mutation from a stray one that must detach first."""

    __slots__ = ("members", "dispatching")

    def __init__(self, members: List["Metric"]) -> None:
        self.members = members
        self.dispatching = False


def _fresh_state_value(v: Any) -> Any:
    """A copy of a state value on storage of its own."""
    if isinstance(v, list):
        return [x.clone() for x in v]
    if isinstance(v, CatBuffer):
        return CatBuffer(v.capacity, None if v.buffer is None else v.buffer.clone(), v.count, v.overflowed)
    return _same_weakness(v, v.clone())


def _is_weak(v: Any) -> bool:
    """Does ``v`` still hold a weakly typed default (``_weak_dtype_states``)?"""
    return isinstance(v, torch.Tensor) and v.__dict__.get("_weak_dtype", False)


def _same_weakness(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst``, marked weakly typed when ``src`` is: a copy of a default is
    still a default."""
    if _is_weak(src):
        dst._weak_dtype = True
    return dst


def _copy_state_value(v: Any) -> Any:
    # a CatBuffer passes as it is: every state restored here (a sync cache,
    # a merged or synced state, the accumulation forward set aside) has no
    # other live holder, so a copy would only cost a clone at the next append
    return list(v) if isinstance(v, list) else v


def _pure_copy(v: Any) -> Any:
    """A state value for a pure call: lists copied, a CatBuffer copied on
    write (its appends must not reach the caller's), tensors by reference
    (updates assign new tensors)."""
    if isinstance(v, list):
        return list(v)
    if isinstance(v, CatBuffer):
        return v.copy()
    return v


def _set_state(m: "Metric", name: str, v: Any) -> None:
    """Assign state ``name`` of ``m`` as it is: no release of a compiled
    program's buffers, no group detach (nn.Module's setattr of a buffer
    looks the name up, which would hand the old value out)."""
    if name in m._buffers and isinstance(v, torch.Tensor):
        m._buffers[name] = v
    else:
        nn.Module.__setattr__(m, name, v)


def _detached(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, list):
        return [x.detach() if isinstance(x, torch.Tensor) else x for x in v]
    return v


def _first_floating_dtype(tree: Any) -> Optional[torch.dtype]:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf.dtype
    return None


def _fire_checkpointer(owner: Any) -> None:
    """Tell ``owner``'s active checkpointer (``Metric.checkpointer``,
    ``MetricCollection.checkpointer``) that its accumulation advanced."""
    ckpt = owner.__dict__.get("_auto_checkpointer")
    if ckpt is not None:
        ckpt.after_update(owner)


def _raise_on_catbuffer_overflow(state: Dict[str, Any], label: str) -> None:
    """An update must not go on accumulating into a CatBuffer that carries the
    overflow flag of a loaded JAX snapshot: its rows are corrupt. (The JAX
    package runs this check after each compiled update, where a traced append
    latches the flag; the port's appends raise before they overflow, so only
    a loaded flag can be set here.) One host bool per CatBuffer state."""
    for name, v in state.items():
        if isinstance(v, CatBuffer) and v.overflowed:
            raise MetricsTPUUserError(
                f"CatBuffer state {name!r} of {label} carries the overflow flag of "
                f"a loaded snapshot (capacity {v.capacity}): its rows were clamped "
                "inside jit where they were accumulated, and are corrupt. Construct "
                "the metric with a larger `with_capacity(...)` and re-run."
            )


def _dtype_category(t: torch.Tensor) -> str:
    if t.is_floating_point() or t.is_complex():
        return "floating"
    return "bool" if t.dtype == torch.bool else "integer"


def _first_item(v: Any) -> Optional[torch.Tensor]:
    """A tensor whose ``shape[1:]`` and dtype are the item spec of a cat-family
    leaf, or None while the leaf is empty."""
    if isinstance(v, CatBuffer):
        return v.buffer
    if isinstance(v, list):
        return v[0] if v else None
    return v


def _merge_leaf_divergences(name: str, a: Any, b: Any, fx: Any, declared: Any) -> List[str]:
    """Reasons leaf ``b`` cannot merge into leaf ``a`` under ``fx`` (empty =
    mergeable): list/"cat" leaves compare item shape and dtype family, reduce
    leaves full shape and dtype family."""
    cat_kinds = (list, CatBuffer)
    cat_family = isinstance(a, cat_kinds) or isinstance(b, cat_kinds) or isinstance(declared, cat_kinds) or fx == "cat"
    if cat_family:
        ia, ib = _first_item(a), _first_item(b)
        if ia is None or ib is None:
            return []
        out = []
        if tuple(ia.shape[1:]) != tuple(ib.shape[1:]):
            out.append(f"{name}: item shape {tuple(ib.shape[1:])} (incoming) vs {tuple(ia.shape[1:])} (self)")
        if _dtype_category(ia) != _dtype_category(ib):
            out.append(f"{name}: item dtype {ib.dtype} (incoming) vs {ia.dtype} (self)")
        return out
    if fx not in _MERGEABLE_FX and not callable(fx):
        return []  # no algebraic merge anyway; merge_states raises its own error
    out = []
    if tuple(a.shape) != tuple(b.shape):
        out.append(f"{name}: shape {tuple(b.shape)} (incoming) vs {tuple(a.shape)} (self)")
    if _dtype_category(a) != _dtype_category(b):
        out.append(f"{name}: dtype {b.dtype} (incoming) vs {a.dtype} (self)")
    return out


class Metric(nn.Module):
    """Base class for all metrics.

    **Subclass contract.** Declare states in ``__init__`` via
    :meth:`add_state` (each with a ``dist_reduce_fx`` of ``"sum"``,
    ``"mean"``, ``"max"``, ``"min"``, ``"cat"``, ``None`` or a callable),
    then implement ``update(*batch)`` (assign to ``self.<state>``) and
    ``compute()``.

    **Composition.** The arithmetic, bitwise and comparison operators build
    a :class:`CompositionalMetric`, as in the JAX package, ``__eq__`` and
    ``__pos__`` (which is ``abs``) included. Unlike the JAX package, which
    hashes the state bytes, a metric hashes by identity: ``nn.Module`` keeps
    modules in sets (``children()``, ``named_modules()``, and so ``.to()``),
    and two members with equal states would otherwise be taken for one,
    since ``==`` returns a (truthy) metric.

    Args:
        compute_on_step: return the batch value from ``forward``.
        dist_sync_on_step: sync state across processes when computing the
            batch value in ``forward``.
        process_group: the ``torch.distributed`` group to sync over
            (``None``: the default group).
        dist_sync_fn: custom ``(state_dict, reductions) -> state_dict``
            replacing the built-in sync.
        device: where the states live. ``None`` means CUDA, and raises when
            CUDA is unavailable; pass ``"cpu"`` to run on the host.
        check_finite: screen every ``update`` for NaN/Inf (see
            :meth:`enable_check_finite`).
        sync_on_error: what a failed host sync does: ``"raise"`` the typed
            ``SyncError``; ``"local"`` keep this process's local state with a
            rank-zero warning; ``"warn"`` the same, warning on every rank.
        sync_on_missing: what a missing-rank failure (a watchdog timeout or a
            divergent header) does: ``"raise"`` leaves it to ``on_error``;
            ``"quorum"`` negotiates the surviving ranks and syncs over them
            (``parallel/resilience.py``; the default world only, so it
            refuses a ``process_group``, and it needs an installed quorum
            transport); ``"local"`` degrades to local state even under
            ``on_error="raise"``.
        sync_timeout: watchdog timeout in seconds of this metric's host
            collectives; ``None`` reads ``METRICS_TPU_SYNC_TIMEOUT_S``
            (default 600), ``0`` disables the watchdog.
        compiled_update: the compiled hot path (see the class attribute).
        sync_mode: ``"blocking"`` (default) or ``"overlap"`` (see the class
            attribute): ``compute()`` resolves a round launched one interval
            earlier on a background lane and launches the next. Needs
            mergeable state.
        staleness_policy: ``"snapshot"`` (default), ``"merge"`` or
            ``"fresh"``: what a resolved round serves when updates ran while
            it was in flight (see the class attribute).
        sync_precision: ``None``/``"full"`` (default), ``"bf16"`` or
            ``"int8"``: the codec of the slow (inter-tier) hop of the tiered
            sync (``parallel/tiering.py``, ``parallel/quantize.py``); flat
            syncs and the intra-tier hops move full precision. It rides the
            health word, so ranks that mix precisions raise
            ``StateDivergenceError`` together.

    ``process_group`` is a ``torch.distributed`` group: the host sync runs
    over it, and it is the default axis of :meth:`pure_sync` and
    :meth:`pure_forward` (the JAX package's is a mesh-axis name, over which
    its host sync raises).

    ``sync_strict_update_count`` (update-count skew raises instead of
    warning), ``sync_fused`` (``None`` follows ``METRICS_TPU_FUSED_SYNC``,
    ``False`` forces the per-leaf payload path), ``sync_mode`` and
    ``staleness_policy`` are plain attributes, as in the JAX package, so they
    can be set on any constructed metric.
    """

    is_differentiable: Optional[bool] = None

    #: Update-count skew at sync raises StateDivergenceError on every rank.
    sync_strict_update_count: bool = False

    #: Bucketed (fused) host-sync payload: ``None`` follows the env knob.
    sync_fused: Optional[bool] = None

    #: The compute group this metric shares state with (set by
    #: ``MetricCollection``), or ``None``.
    _compute_group: Optional[_ComputeGroup] = None

    #: The active :class:`~metrics_tpu_torch.core.checkpoint.MetricCheckpointer`
    #: of :meth:`checkpointer`, or ``None``.
    _auto_checkpointer: Optional[Any] = None

    #: Instance attributes an update writes as side effects (an input-mode
    #: latch, an inferred ``num_classes``): after a group dispatch the
    #: collection copies them from the member that ran the update to the
    #: others. A family that declares ``update_identity`` and latches
    #: attributes in ``update`` must list them here.
    _group_shared_attrs: Tuple[str, ...] = ()

    #: The compiled hot path (``core/compiled.py``): ``None`` follows
    #: ``METRICS_TPU_COMPILED_UPDATE`` after the warm-up, ``True`` compiles
    #: from the first step, ``False`` keeps this metric eager.
    compiled_update: Optional[bool] = None

    #: States whose float32 default is weakly typed, as the JAX package's
    #: ``jnp.asarray(0.0)``: while a state still holds a default (after
    #: construction, ``reset``, or as ``forward``'s batch state), the update's
    #: floating input dtype becomes its own (a bfloat16 batch keeps a
    #: bfloat16 sum); what an update wrote keeps its dtype.
    _weak_dtype_states: Tuple[str, ...] = ()

    #: The default of ``sync()`` and of ``compute()``'s automatic sync:
    #: ``"blocking"`` gathers inline; ``"overlap"`` pipelines, each
    #: ``compute()`` resolving the round launched at the previous one and
    #: launching the next (the first serves the local accumulation, counted
    #: as ``served_local``).
    sync_mode: str = "blocking"

    #: What a resolved round serves when ``update()`` ran while it was in
    #: flight: ``"snapshot"`` the world state at the snapshot cut (the same
    #: on every rank), ``"merge"`` that plus this rank's later delta,
    #: ``"fresh"`` raises :class:`StaleSyncError` (degradable by ``on_error``).
    #: Stale resolves are counted under every policy.
    staleness_policy: str = "snapshot"

    #: The in-flight overlapped round (``parallel/async_sync.py``), or ``None``.
    _inflight: Optional[AsyncSyncRound] = None

    #: The ``MetricCollection`` whose overlapped round covers this metric's
    #: state, or ``None``: this member's reads resolve that round.
    _inflight_collection: Optional[Any] = None

    #: The overlapped round counter the health word carries (``core/plan.py``).
    _sync_epoch: int = 0

    #: The slow hop's codec of the tiered sync (``None``: full precision).
    sync_precision: Optional[str] = None

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
        check_finite: bool = False,
        sync_on_error: str = "raise",
        sync_on_missing: str = "raise",
        sync_timeout: Optional[float] = None,
        compiled_update: Optional[bool] = None,
        sync_mode: str = "blocking",
        staleness_policy: str = "snapshot",
        sync_precision: Optional[str] = None,
    ) -> None:
        super().__init__()
        if compiled_update is not None:
            self.compiled_update = compiled_update
        if sync_mode not in _SYNC_MODES:
            raise MetricsTPUUserError(f"`sync_mode` must be one of {_SYNC_MODES}, got {sync_mode!r}")
        self.sync_mode = sync_mode
        self.staleness_policy = validate_staleness_policy(staleness_policy)
        self._device = resolve_device(device)
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Any] = {}
        self._persistent: Dict[str, bool] = {}
        self.compute_on_step = compute_on_step
        self.dist_sync_on_step = dist_sync_on_step
        self.process_group = process_group
        self.dist_sync_fn = dist_sync_fn
        self.sync_on_error = _check_on_error(sync_on_error)
        self.sync_on_missing = _sync.check_on_missing(sync_on_missing, process_group)
        self.sync_precision = validate_sync_precision(sync_precision)
        self.sync_timeout = sync_timeout
        self._update_called = False
        self._update_count = 0
        self._computed: Any = None
        self._forward_cache: Any = None
        self._to_sync = True
        self._is_synced = False
        self._sync_degraded = False
        self._cache: Optional[Dict[str, Any]] = None
        self._dtype: Optional[torch.dtype] = None
        self.check_finite = False
        if check_finite:
            self.enable_check_finite()

    def __setattr__(self, name: str, value: Any) -> None:
        d = self.__dict__
        if name in d.get("_defaults", ()) and not d.get("_pure_mode", False):
            if d.get("_donation_ready", False):
                self._release_compiled_state("state-write")
            group = d.get("_compute_group")
            if group is not None and not group.dispatching:
                # a direct state assignment on a grouped member (m.tp = ...)
                # is an out-of-group mutation: leave the group first, or the
                # next group dispatch would revert it when re-linking
                self._group_detach_if_stray()
        super().__setattr__(name, value)

    def __getattr__(self, name: str) -> Any:
        # reached for the tensor states (nn.Module buffers): a state handed
        # out while it is a compiled program's static buffer would change
        # under the next replay, so the metric first takes copies of its own
        d = self.__dict__
        if d.get("_donation_ready", False) and name in d["_defaults"] and not d.get("_pure_mode", False):
            self._release_compiled_state("state-read")
        return super().__getattr__(name)

    def __getstate__(self) -> Dict[str, Any]:
        # an in-flight round's future cannot be copied: drain it first (the
        # fold-back keeps the accumulation); copies and pickles start with no
        # programs: they hold the original instance's buffers, and the
        # compile counters describe it alone
        self._drain_rounds_for_copy()
        state = dict(self.__dict__)
        for key in ("_compiled", "_plan_binding", "_donation_ready", "_inflight", "_inflight_collection"):
            state.pop(key, None)
        reg = state.get("_telemetry")
        if reg is not None:
            state["_telemetry"] = reg.with_fresh_domain("compile")
        return state

    # ------------------------------------------------------------------
    # state declaration
    # ------------------------------------------------------------------

    def add_state(
        self,
        name: str,
        default: Union[torch.Tensor, list, int, float],
        dist_reduce_fx: Union[str, Callable, None] = None,
        persistent: bool = False,
    ) -> None:
        """Register a named state with its cross-process reduction.

        ``default`` is a tensor (the reset value, placed on the metric's
        device) or an empty list (a "cat" state that accumulates per-batch
        tensors). ``dist_reduce_fx`` is both the cross-process reduction and
        the merge rule used by ``forward`` and :meth:`merge_state`.
        ``persistent`` states are written by ``state_dict()``.
        """
        if isinstance(default, list):
            if default:
                raise ValueError("state variable must be a tensor or an empty list")
        elif not isinstance(default, (torch.Tensor, int, float)):
            raise ValueError("state variable must be a tensor or an empty list")
        if dist_reduce_fx is not None and not (
            dist_reduce_fx in ("sum", "mean", "cat", "max", "min") or callable(dist_reduce_fx)
        ):
            raise ValueError(
                "`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'max', 'min', None]"
            )
        self._reductions[name] = dist_reduce_fx
        self._persistent[name] = persistent
        if isinstance(default, list):
            self._defaults[name] = []
            setattr(self, name, [])
        else:
            default = torch.as_tensor(default).to(self._device)
            if name in type(self)._weak_dtype_states:
                default._weak_dtype = True
            self._defaults[name] = default
            self.register_buffer(name, _same_weakness(default, default.clone()), persistent=False)

    @property
    def device(self) -> torch.device:
        """The device holding this metric's states."""
        return self._device

    @property
    def _state(self) -> Dict[str, Any]:
        d = self.__dict__
        if d.get("_donation_ready", False) and not d.get("_pure_mode", False):
            self._release_compiled_state("state-read")
        return {name: getattr(self, name) for name in self._defaults}

    def _raw_state(self) -> Dict[str, Any]:
        """The state objects as they are, without handing them out (the
        compiled path's own access)."""
        buffers, d = self._buffers, self.__dict__
        return {name: buffers[name] if name in buffers else d[name] for name in self._defaults}

    def _restore(self, state: Dict[str, Any]) -> None:
        # nn.Module's own setattr: restoring (a sync, its unsync, a group
        # re-link) is not a stray mutation that leaves a compute group
        d = self.__dict__
        if d.get("_donation_ready", False) and not d.get("_pure_mode", False):
            if d.get("_compute_group") is None and set(state) >= set(self._defaults):
                plan_mod.mark_state_mutated(self, "restore")  # every state is replaced: nothing to copy
            else:
                self._release_compiled_state("restore")
        for k, v in state.items():
            nn.Module.__setattr__(self, k, _copy_state_value(v))

    def _release_compiled_state(self, reason: str) -> None:
        """The metric's states are a compiled program's static buffers (the
        donation latch is set): give it, and the compute-group members that
        share them, copies of their own, so that nothing handed out changes
        under a later replay. The next dispatch copies the state back in."""
        group = self.__dict__.get("_compute_group")
        members = list(group.members) if group is not None else []
        if self not in members:
            members.append(self)
        fresh = {name: _fresh_state_value(v) for name, v in self._raw_state().items()}
        for m in members:
            if m.__dict__.get("_donation_ready", False):
                for name, v in fresh.items():
                    _set_state(m, name, v)
                plan_mod.mark_state_mutated(m, reason)

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "Metric":
        # buffers move with nn.Module's own _apply; the defaults and the
        # list states are not buffers and move here
        self._group_detach_if_stray()
        if self.__dict__.get("_donation_ready", False):
            self._release_compiled_state("apply")
        # programs read the old defaults and buffers by address
        self._drop_programs()
        weak = [n for n, v in self._raw_state().items() if _is_weak(v)]
        this = super()._apply(fn, *args, **kwargs)
        for name in weak:
            this._buffers[name]._weak_dtype = True
        for name, default in this._defaults.items():
            live = getattr(this, name)
            if isinstance(default, torch.Tensor):
                this._defaults[name] = _same_weakness(default, fn(default))
            elif isinstance(default, CatBuffer):
                default._apply(fn)
            if isinstance(live, CatBuffer):
                live._apply(fn)
            elif isinstance(live, list):
                nn.Module.__setattr__(this, name, [fn(v) for v in live])
        # a cast of every floating dtype to one (``half()``, ``.to(dtype)``,
        # ``set_dtype``, also from a parent module) is recorded, so that the
        # update wrapper re-casts after every update
        lo, hi = (fn(torch.zeros(0, dtype=d, device=this._device)) for d in (torch.float16, torch.float64))
        if lo.dtype == hi.dtype:
            this._dtype = lo.dtype
        this._device = lo.device
        return this

    def set_dtype(self, dtype: torch.dtype) -> "Metric":
        """Cast the floating states (and every other floating tensor of the
        module, as ``nn.Module.half()`` does) to ``dtype``, and keep them
        there: the update wrapper re-casts after each update, since
        ``state + batch_stat`` promotes a half state back to float32.
        Applies to nested metrics too. Counterpart of the JAX package's
        ``set_dtype``, which truncates float64 to float32 without x64; here
        float64 stays float64."""
        return self._apply(lambda t: t.to(dtype) if t.is_floating_point() else t)

    def type(self, dst_type: torch.dtype) -> "Metric":  # type: ignore[override]
        """Alias of :meth:`set_dtype` (integer states keep their dtype)."""
        return self.set_dtype(dst_type)

    def half(self) -> "Metric":
        """``set_dtype(torch.float16)``."""
        return self.set_dtype(torch.float16)

    def float(self) -> "Metric":
        """``set_dtype(torch.float32)``."""
        return self.set_dtype(torch.float32)

    def double(self) -> "Metric":
        """``set_dtype(torch.float64)``."""
        return self.set_dtype(torch.float64)

    # ------------------------------------------------------------------
    # stateful API
    # ------------------------------------------------------------------

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the batch into state and return the batch-local value.

        The batch runs through ``update`` on fresh state, its value is
        computed, and the batch state is merged into the accumulation — one
        update per batch where the state algebra allows, the reference's
        double update otherwise. A metric declared differentiable computes
        the batch value with grad when an input requires it; the running
        states stay detached. After the warm-up the step replays as one
        compiled program (``core/compiled.py``), except a step with grad.
        """
        if self._is_synced:
            raise MetricsTPUUserError(
                "The Metric shouldn't be synced when performing ``update``. "
                "HINT: Did you forget to call ``unsync``?"
            )
        if not self.compute_on_step:
            self.update(*args, **kwargs)
            return None
        grad = self._forward_needs_grad(args, kwargs)
        if not grad:
            handled, value = self._maybe_compiled_forward(args, kwargs)
            if handled:
                return value

        # a stray forward on a grouped member leaves the group before the
        # accumulation is set aside: the merge below appends into it in place
        self._group_detach_if_stray()
        accumulated = self._state
        # the auto-checkpointer must not fire off the transient batch state
        # the inner update writes; it snapshots the merged accumulation below
        object.__setattr__(self, "_ckpt_suppress", True)
        try:
            self._restore(self._batch_default_state())
            object.__setattr__(self, "_grad_batch", grad)
            try:
                self.update(*args, **kwargs)
                batch_state = self._state

                # the compute wrapper syncs the batch value only if dist_sync_on_step
                self._to_sync = self.dist_sync_on_step
                self._computed = None
                try:
                    self._forward_cache = self.compute()
                finally:
                    self._to_sync = True
            finally:
                object.__setattr__(self, "_grad_batch", False)
            self._computed = None
            if self.dist_sync_on_step:
                batch_state = self._state  # the sync context restored the local batch state
            if grad:
                batch_state = {k: _detached(v) for k, v in batch_state.items()}
            accumulated = self._adopt_weak_dtypes(accumulated, (args, kwargs))

            if self._can_merge():
                try:
                    merged = self._forward_merge(accumulated, batch_state)
                except Exception:
                    self._restore(accumulated)
                    raise
                self._restore(merged)
            else:
                self._restore(accumulated)
                self.update(*args, **kwargs)
        finally:
            object.__setattr__(self, "_ckpt_suppress", False)
        _fire_checkpointer(self)
        return self._forward_cache

    def _forward_merge(self, accumulated: Dict[str, Any], batch_state: Dict[str, Any]) -> Dict[str, Any]:
        if type(self).merge_states is Metric.merge_states:
            # the accumulation set aside has no other holder: its CatBuffers
            # take the batch rows in place (an append that would overflow
            # raises before it writes)
            return self._merge_states(accumulated, batch_state, in_place=True)
        return self.merge_states(accumulated, batch_state)

    def _forward_needs_grad(self, args: Tuple, kwargs: Dict[str, Any]) -> bool:
        """Does this ``forward`` compute its batch value with grad? Only for a
        metric declared differentiable, with grad enabled and an input that
        requires it."""
        if self.is_differentiable is not True or not torch.is_grad_enabled():
            return False
        return any(isinstance(x, torch.Tensor) and x.requires_grad for x in pytree.tree_leaves((args, kwargs)))

    def _adopt_weak_dtypes(self, state: Dict[str, Any], inputs: Any) -> Dict[str, Any]:
        """``state`` with its weakly typed defaults (``_weak_dtype_states``
        still holding a default) cast to the first floating input's dtype."""
        names = [n for n in type(self)._weak_dtype_states if _is_weak(state.get(n))]
        dtype = _first_floating_dtype(inputs) if names else None
        if dtype is None:
            return state
        out = dict(state)
        for name in names:
            if out[name].is_floating_point() and out[name].dtype != dtype:
                out[name] = out[name].to(dtype)
        return out

    def _default_value(self, name: str) -> Any:
        """A fresh copy of state ``name``'s default (weak where declared)."""
        v = self._defaults[name]
        if isinstance(v, torch.Tensor):
            return _same_weakness(v, v.clone())
        return v.reset() if isinstance(v, CatBuffer) else []

    def update(self, *args: Any, **kwargs: Any) -> None:  # noqa: D102 - abstract
        raise NotImplementedError(f"Metric {type(self).__name__} must implement `update`.")

    def compute(self) -> Any:  # noqa: D102 - abstract
        raise NotImplementedError(f"Metric {type(self).__name__} must implement `compute`.")

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        if "update" in cls.__dict__ and not getattr(cls.update, "_wrapped", False):
            cls.update = _wrap_update(cls.update)
        if "compute" in cls.__dict__ and not getattr(cls.compute, "_wrapped", False):
            cls.compute = _wrap_compute(cls.compute)

    # ------------------------------------------------------------------
    # sync
    # ------------------------------------------------------------------

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
        """Replace the local state by its cross-process reduction, keeping the
        local state to restore at :meth:`unsync`.

        A no-op unless more than one process takes part (or
        ``distributed_available()`` says so). ``dist_sync_fn`` (or the
        constructor's) replaces the built-in sync, which checks the health
        header on every rank before any payload moves
        (``parallel/health.py``) and runs each collective under the watchdog,
        over ``process_group`` (the JAX package raises on a host sync over
        its mesh-axis ``process_group``).

        ``on_error`` / ``on_missing`` / ``timeout`` default to the
        constructor's ``sync_on_error`` / ``sync_on_missing`` /
        ``sync_timeout``. A typed ``SyncError`` then propagates
        (``"raise"``), or the metric keeps its local state and warns
        (``"local"`` on rank zero, ``"warn"`` on every rank), and a paired
        :meth:`unsync` is a no-op. ``on_missing="local"`` degrades a
        missing-rank failure (a watchdog timeout, a divergent header) even
        under ``on_error="raise"``.

        ``blocking=False`` (the default under ``sync_mode="overlap"``)
        launches a non-blocking round instead (``parallel/async_sync.py``):
        the accumulation moves into a snapshot the background lane gathers,
        the metric restarts on fresh state and stays un-synced, and the
        next ``compute()``/``sync()``/``state_dict()`` resolves the round.
        A ``sync()`` while a round is in flight resolves it, whatever
        ``blocking`` says, and under ``blocking=False`` launches the next.
        """
        if self._is_synced and should_sync:
            raise MetricsTPUUserError("The Metric has already been synced.")
        on_error = _check_on_error(self.sync_on_error if on_error is None else on_error)
        on_missing = _sync.check_on_missing(self.sync_on_missing if on_missing is None else on_missing,
                                            self.process_group)
        overlap_default = self.sync_mode == "overlap"
        if blocking is None:
            blocking = not overlap_default
        if should_sync:
            # an in-flight round resolves whatever the distributed predicate
            # says now: it was launched in a world, and consuming it issues
            # no new collective
            owner = self.__dict__.get("_inflight_collection")
            if owner is not None:
                owner._resolve_member_request(self, on_error=on_error, on_missing=on_missing, timeout=timeout)
                return
            if self.__dict__.get("_inflight") is not None:
                self._resolve_overlap(on_error=on_error, on_missing=on_missing, timeout=timeout,
                                      relaunch=not blocking, dist_sync_fn=dist_sync_fn)
                return
        is_distributed = (
            distributed_available() if distributed_available is not None else self._distributed_available()
        )
        if not should_sync or not is_distributed:
            return
        if not blocking:
            # from the overlap pipeline (sync_mode="overlap") the caller is
            # about to read: serve the local accumulation this first time
            self._launch_overlap(dist_sync_fn=dist_sync_fn, timeout=timeout, serve_local=overlap_default,
                                 on_missing=on_missing)
            return
        self._cache = self._state
        self._sync_degraded = False
        try:
            synced = self._run_dist_sync(self._cache, timeout=timeout, fn=dist_sync_fn, on_missing=on_missing)
        except SyncError as err:
            self._handle_sync_failure(err, on_error, on_missing)
            return
        self._restore(synced)
        self._is_synced = True

    def _attribute_plan(self, state: Dict[str, Any]) -> None:
        """Take this schema's plan build or hit into this metric's ``plan``
        telemetry: the bucketed sync consults the store where no owner is in
        scope (the background lane included). Skipped on the per-leaf path,
        which reads no plan."""
        fused = self.sync_fused
        if fused_sync_enabled() if fused is None else fused:
            plan_mod.plan_for(state, self._reductions, owner=self)

    def _run_dist_sync(
        self,
        state: Dict[str, Any],
        timeout: Optional[float] = None,
        fn: Optional[Callable] = None,
        on_missing: str = "raise",
    ) -> Dict[str, Any]:
        """The sync transport: ``fn`` (or ``self.dist_sync_fn``) when set,
        else the built-in health-checked host sync with this metric's knobs.
        A custom transport too runs after the rounds this process launched
        (it has no epoch header to catch a mispairing)."""
        fn = fn or self.dist_sync_fn
        if fn is not None:
            from metrics_tpu_torch.parallel.async_sync import sync_channel

            with sync_channel():
                return fn(dict(state), self._reductions)
        self._attribute_plan(state)
        return _sync.host_sync_state(
            state,
            self._reductions,
            self.process_group,
            update_count=self._update_count,
            strict_update_count=self.sync_strict_update_count,
            timeout=self.sync_timeout if timeout is None else timeout,
            metric_name=type(self).__name__,
            fused=self.sync_fused,
            on_missing=on_missing,
            stats=self._sync_stats_dict(),
            sync_precision=self.sync_precision,
        )

    def _handle_sync_failure(self, err: SyncError, on_error: str, on_missing: str = "raise") -> None:
        """The ``on_error`` ladder of a failed sync; the local state was never
        touched. Re-raises under ``"raise"``; otherwise marks the degradation
        (so a paired :meth:`unsync` is a no-op) and warns, louder when this
        rank's own state is the poisoned one."""
        if on_missing == "local" and on_error == "raise" and is_missing_rank_error(err):
            on_error = "local"
        self._cache = None
        registry_of(self).count_error(err, degraded=on_error != "raise")
        if journal.ACTIVE:
            journal.record(
                "health.failure", label=type(self).__name__, step=self._update_count,
                error=type(err).__name__, on_error=on_error,
            )
        if on_error == "raise":
            raise err
        self._sync_degraded = True
        if journal.ACTIVE:
            journal.record(
                "degrade.local", label=type(self).__name__, step=self._update_count,
                error=type(err).__name__, on_error=on_error,
            )
        if isinstance(err, NonFiniteStateError) and self._local_state_poisoned():
            # degradation promises a partial but correct value; this rank's
            # own state is corrupt, so every rank that holds such state warns
            warnings.warn(
                f"Cross-process sync of {type(self).__name__} failed "
                f"({type(err).__name__}: {err}): falling back to LOCAL-ONLY "
                "state, and THIS process's own state is NaN/Inf-poisoned: "
                "reported values are CORRUPT, not merely partial.",
                RuntimeWarning,
                stacklevel=3,
            )
            return
        msg = (
            f"Cross-process sync of {type(self).__name__} failed "
            f"({type(err).__name__}: {err}): falling back to LOCAL-ONLY "
            "state; reported values cover this process's data only."
        )
        if on_error == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
        else:
            rank_zero_warn(msg, RuntimeWarning)

    def _distributed_available(self) -> bool:
        return _sync.distributed_available(self.process_group)

    # ------------------------------------------------------------------
    # telemetry (observability/registry.py)
    # ------------------------------------------------------------------

    def _sync_stats_dict(self) -> Dict[str, Any]:
        return registry_of(self).domain("sync")

    def sync_stats(self) -> Dict[str, Any]:
        """The ``sync`` domain of :meth:`telemetry`: the overlapped rounds
        ``launched``, ``resolved``, ``cancelled``, ``stale_resolves``,
        ``degraded`` (a resolve that fell back to local state),
        ``served_local`` (an overlap-mode read before any round resolved),
        and the wall-clock ledger: ``gather_s`` (the background
        collectives), ``resolve_wait_s`` (how long resolves blocked) and
        ``overlap_saved_s`` (their difference: the collective time hidden
        behind the step). Blocking syncs count no round, as in the JAX
        package. A tiered sync adds its hops' bytes to
        ``intra_tier_bytes``, ``inter_tier_bytes`` and
        ``inter_tier_bytes_saved``."""
        return dict(registry_of(self).domain("sync"))

    def compile_stats(self) -> Dict[str, Any]:
        """The compiled hot path's counters, the ``compile`` domain of
        :meth:`telemetry`: ``traces`` counts program builds (a capture each on
        the card; a growing number under a steady workload means shape
        churn), ``dispatches`` compiled steps (``cache_hits`` = dispatches -
        traces), ``steps_seen`` the steps the warm-up counted, ``fallback``
        maps ``"update"``/``"forward"`` to the reason this instance runs
        eagerly, or is ``None``."""
        return compile_stats_view(registry_of(self).domain("compile"))

    def telemetry(self, delta: bool = False) -> Dict[str, Any]:
        """This metric's telemetry snapshot, in the JAX package's layout and
        schema (``metrics_tpu.telemetry.v1``): the ``compile``, ``sync``,
        ``checkpoint``, ``health`` and ``plan`` domains and the ``process``
        counters. ``delta=True`` gives the numeric change since the previous
        ``telemetry(delta=True)`` (the first against zero). Encode with
        :func:`~metrics_tpu_torch.observability.telemetry_jsonl` or
        :func:`~metrics_tpu_torch.observability.telemetry_prometheus`. Reads
        no device."""
        reg = registry_of(self)
        extra = {"compile": self.compile_stats()}
        return reg.delta(extra) if delta else reg.snapshot(extra)

    def _local_state_poisoned(self) -> bool:
        """Is THIS rank's own state NaN/Inf-poisoned (``check_finite``)?"""
        return NONFINITE_STATE in self._defaults and state_poisoned(self._state)

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the local state saved by :meth:`sync`. After a sync that
        degraded to local state, a no-op. With a round launched and not
        resolved, the symmetric cancel: the round is drained on every rank
        (never un-queued, which could strand a peer mid-collective), its
        result discarded and the snapshot folded back into the live state,
        so no data is lost."""
        if not should_unsync:
            return
        if not self._is_synced:
            if self.__dict__.get("_inflight") is not None:
                self._cancel_overlap()
                return
            if self._sync_degraded:
                self._sync_degraded = False
                return
            raise MetricsTPUUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsTPUUserError("The internal cache should exist to unsync the Metric.")
        self._restore(self._cache)
        self._is_synced = False
        self._cache = None

    class _SyncContext:
        def __init__(self, metric: "Metric", should_unsync: bool, **kwargs: Any) -> None:
            self.metric = metric
            self.kwargs = kwargs
            self.should_unsync = should_unsync

        def __enter__(self) -> "Metric":
            self.metric.sync(**self.kwargs)
            return self.metric

        def __exit__(self, *exc: Any) -> None:
            self.metric.unsync(should_unsync=self.metric._is_synced and self.should_unsync)

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
    ) -> "Metric._SyncContext":
        """Context manager: sync on enter, restore the local state on exit."""
        return Metric._SyncContext(
            self,
            should_unsync,
            dist_sync_fn=dist_sync_fn,
            should_sync=should_sync,
            distributed_available=distributed_available,
            on_error=on_error,
            on_missing=on_missing,
            timeout=timeout,
            blocking=blocking,
        )

    # ------------------------------------------------------------------
    # overlapped (non-blocking, double-buffered) sync
    # ------------------------------------------------------------------

    def _overlap_refusal(self) -> Optional[str]:
        """Why this metric cannot overlap its sync (``None``: it can)."""
        if not self._can_merge():
            return (
                "its state has no algebraic merge, so the post-snapshot delta could never be folded "
                "back (override `merge_states` or use mergeable reductions; blocking sync only)"
            )
        if self.dist_sync_on_step:
            return (
                "dist_sync_on_step syncs the batch state inside every forward(), which cannot compose "
                "with an in-flight accumulation round"
            )
        return None

    def _launch_overlap(
        self,
        dist_sync_fn: Optional[Callable] = None,
        timeout: Optional[float] = None,
        serve_local: bool = False,
        on_missing: Optional[str] = None,
    ) -> None:
        """Snapshot the accumulation, launch its gather, return. The round
        takes the state objects (a host gather never changes its input) and
        the metric restarts on fresh defaults, the delta buffers updates go
        to. ``serve_local`` (the overlap pipeline's first read) serves the
        snapshot as this read's value: the state points at it, and the
        fresh delta buffers wait in the unsync cache."""
        reason = self._overlap_refusal()
        if reason is not None:
            raise MetricsTPUUserError(f"non-blocking sync of {type(self).__name__} refused: {reason}.")
        self._group_detach_if_stray()
        snapshot = self._state
        self._restore(self.init_state())
        self._launch_overlap_from(snapshot, dist_sync_fn, timeout, on_missing=on_missing)
        if serve_local:
            self._cache = self._state
            self._sync_degraded = False
            self._restore(self._inflight.snapshot)
            self._is_synced = True
            self._sync_stats_dict()["served_local"] += 1

    def _launch_overlap_from(
        self,
        snapshot: Dict[str, Any],
        dist_sync_fn: Optional[Callable],
        timeout: Optional[float],
        on_missing: Optional[str] = None,
    ) -> None:
        """Launch one round over ``snapshot`` (which the round now owns)."""
        plan_mod.next_sync_epoch(self)
        fn = dist_sync_fn or self.dist_sync_fn
        sync_fn = None
        if fn is not None:
            reductions = self._reductions
            sync_fn = lambda: fn(dict(snapshot), reductions)  # noqa: E731
        else:
            # the plan is warmed and attributed here: the lane has no owner
            self._attribute_plan(snapshot)
        round_ = launch_round(
            snapshot,
            self._reductions,
            update_count=self._update_count,
            epoch=self._sync_epoch,
            metric_name=type(self).__name__,
            group=self.process_group,
            strict_update_count=self.sync_strict_update_count,
            timeout=self.sync_timeout if timeout is None else timeout,
            fused=self.sync_fused,
            sync_fn=sync_fn,
            on_missing=self.sync_on_missing if on_missing is None else on_missing,
            stats=self._sync_stats_dict(),
            sync_precision=self.sync_precision,
        )
        object.__setattr__(self, "_inflight", round_)
        self._sync_stats_dict()["launched"] += 1

    def _fold_back_round(self, round_: AsyncSyncRound, stale: bool) -> None:
        """Restore the full local accumulation, the round's snapshot merged
        with the delta since the launch: every failure and cancel path runs
        this first, so a round never loses data."""
        self._restore(self.merge_states(round_.snapshot, self._state) if stale else round_.snapshot)
        self._cache = None

    def _resolve_overlap(
        self,
        on_error: Optional[str] = None,
        on_missing: Optional[str] = None,
        timeout: Optional[float] = None,
        relaunch: bool = False,
        dist_sync_fn: Optional[Callable] = None,
    ) -> None:
        """Consume the in-flight round: wait for its result (about 0 when
        the gather finished behind the step), judge staleness against the
        snapshot's update count, apply :attr:`staleness_policy`, and leave
        the metric synced as a blocking :meth:`sync` would. A failure (the
        round's typed error, or a stale resolve under ``"fresh"``) restores
        the full local accumulation first, then runs the ``on_error``
        ladder. ``relaunch`` (the overlap pipeline) hands the restored local
        accumulation to the next round."""
        on_error = _check_on_error(self.sync_on_error if on_error is None else on_error)
        on_missing = self.sync_on_missing if on_missing is None else on_missing
        round_ = self.__dict__["_inflight"]
        object.__setattr__(self, "_inflight", None)
        stats = self._sync_stats_dict()
        stale = self._update_count > round_.update_count
        try:
            synced, wait_s = resolve_round(round_, timeout=self.sync_timeout if timeout is None else timeout)
        except SyncError as err:
            self._fold_back_round(round_, stale)
            self._handle_sync_failure(err, on_error, on_missing)  # raises under "raise"
            stats["degraded"] += 1
            return
        stats["resolved"] += 1
        stats["gather_s"] += round_.gather_s
        stats["resolve_wait_s"] += wait_s
        stats["overlap_saved_s"] += max(0.0, round_.gather_s - wait_s)
        policy = self.staleness_policy
        if journal.ACTIVE:
            journal.record(
                "sync.resolve", label=type(self).__name__, step=self._update_count, sync_epoch=round_.epoch,
                stale=stale, policy=policy, verdict=("stale:" + policy) if stale else "fresh", wait_s=wait_s,
                gather_s=round_.gather_s, gather_start=round_.gather_started,
            )
        if stale:
            stats["stale_resolves"] += 1
            if policy == "fresh":
                self._fold_back_round(round_, stale)
                self._handle_sync_failure(
                    StaleSyncError(
                        f"overlapped sync round {round_.epoch} of {type(self).__name__} resolved stale: "
                        f"{self._update_count - round_.update_count} update() call(s) ran after the snapshot "
                        "was taken (staleness_policy='fresh'). Resolve before updating, or accept bounded "
                        "staleness with staleness_policy='snapshot'|'merge'."
                    ),
                    on_error,
                )
                stats["degraded"] += 1
                return
            delta = self._state
            local = self.merge_states(round_.snapshot, delta)
            view = self.merge_states(synced, delta) if policy == "merge" else synced
        else:
            local, view = round_.snapshot, synced
        self._cache = local
        self._sync_degraded = False
        self._restore(view)
        self._is_synced = True
        if relaunch:
            # the pipeline: the full local accumulation goes to the next
            # round, the unsync cache gets fresh delta buffers
            next_snapshot, self._cache = self._cache, self.init_state()
            self._launch_overlap_from(next_snapshot, dist_sync_fn, timeout, on_missing=on_missing)

    def _cancel_overlap(self) -> None:
        """The symmetric cancel (``unsync()``, ``reset()``, a copy): drain
        the round on every rank, discard its result or its error, and fold
        the snapshot back, so the state is what it would be without the
        launch."""
        round_ = self.__dict__.get("_inflight")
        if round_ is None:
            return
        object.__setattr__(self, "_inflight", None)
        drain_round(round_, timeout=self.sync_timeout)
        self._sync_stats_dict()["cancelled"] += 1
        if self._is_synced:
            # mid-pipeline (a resolved round served, the next in flight):
            # the drained round holds the local accumulation; updates are
            # refused while synced, so the delta cache it replaces is empty
            self._cache = round_.snapshot
        else:
            self._fold_back_round(round_, self._update_count > round_.update_count)

    def _drain_rounds_for_copy(self) -> None:
        """Before a copy or a pickle: drain the round that holds this
        metric's accumulation, its own or its collection's (a copy taken
        without the fold-back would hold only the delta)."""
        owner = self.__dict__.get("_inflight_collection")
        if owner is not None:
            owner._cancel_overlap()
        self._cancel_overlap()

    # ------------------------------------------------------------------
    # merge / reset / clone
    # ------------------------------------------------------------------

    def _can_merge(self) -> bool:
        if type(self).merge_states is not Metric.merge_states:
            return True
        return all(
            fx in _MERGEABLE_FX or isinstance(self._defaults[name], (list, CatBuffer))
            for name, fx in self._reductions.items()
        )

    def _batch_default_state(self) -> Dict[str, Any]:
        """Fresh state for one batch of ``forward``: CatBuffer states start as
        plain lists, so that a batch costs O(batch), not O(capacity); the
        merge appends its rows into the accumulation's buffer."""
        return {k: [] if isinstance(v, CatBuffer) else _copy_state_value(v) for k, v in self._defaults.items()}

    def merge_states(self, state_a: Dict[str, Any], state_b: Dict[str, Any]) -> Dict[str, Any]:
        """Merge two accumulated states of this metric into one, by each
        state's reduction: sum → add, cat → concat, max/min → elementwise.
        List and CatBuffer states merge with each other; neither input is
        changed."""
        return self._merge_states(state_a, state_b)

    def _merge_states(self, state_a: Dict[str, Any], state_b: Dict[str, Any], in_place: bool = False) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, fx in self._reductions.items():
            a, b = state_a[name], state_b[name]
            if isinstance(a, CatBuffer) and isinstance(b, list):
                merged = a if in_place else a.copy()
                for x in b:
                    merged.append(x)
                out[name] = merged
            elif isinstance(a, CatBuffer):
                out[name] = a.merge(b)
            elif isinstance(b, CatBuffer):
                # merging INTO a list state loses the overflow flag, so a
                # corrupt buffer must fail here, loudly; the flag is a host
                # bool (CatBuffer.overflowed), never a read of the device
                if b.overflowed:  # metricslint: disable=host-sync-in-update
                    raise MetricsTPUUserError(
                        f"State {name!r} holds a CatBuffer that overflowed inside "
                        "jit: its rows are corrupt and cannot be merged into a "
                        "list-state metric. Re-run with a larger capacity."
                    )
                out[name] = list(a) + ([b.values().clone()] if len(b) else [])
            elif isinstance(self._defaults[name], list):
                out[name] = list(a) + list(b)
            elif fx == "sum":
                out[name] = a + b
            elif fx == "max":
                out[name] = torch.maximum(a, b)
            elif fx == "min":
                out[name] = torch.minimum(a, b)
            elif fx == "cat":
                out[name] = torch.cat([torch.atleast_1d(a), torch.atleast_1d(b)])
            else:
                raise MetricsTPUUserError(
                    f"State {name!r} with reduction {fx!r} has no algebraic merge; "
                    f"override `merge_states` in {type(self).__name__}."
                )
        return out

    def _validate_merge_schema(self, other: Dict[str, Any], what: str) -> None:
        missing = [n for n in self._reductions if n not in other]
        unexpected = [n for n in sorted(other) if n not in self._reductions]
        state = self._state
        divergent: List[str] = []
        for name, fx in self._reductions.items():
            if name in other:
                divergent.extend(_merge_leaf_divergences(name, state[name], other[name], fx, self._defaults[name]))
        if missing or unexpected or divergent:
            raise StateSchemaError(
                f"merge_state: incoming {what} does not match "
                f"{type(self).__name__}'s state schema: "
                + "; ".join(
                    ([f"missing states: {missing}"] if missing else [])
                    + ([f"unexpected states: {unexpected}"] if unexpected else [])
                    + divergent
                )
            )

    def merge_state(self, incoming: Union["Metric", Dict[str, Any]]) -> None:
        """Merge another metric's (or raw state dict's) accumulation into
        self. An incompatible schema raises :class:`StateSchemaError` naming
        the divergent leaves, before any state changes."""
        if isinstance(incoming, Metric):
            other, what = incoming._state, type(incoming).__name__
        else:
            other, what = incoming, "state dict"
        self._validate_merge_schema(other, what)
        self._group_detach_if_stray()
        self._restore(self.merge_states(self._state, other))
        self._computed = None

    def reset(self) -> None:
        """Reset every state to its default. A round that holds this
        metric's accumulation (its own, or its collection's) is drained
        first: its collectives were launched on every rank, and a later
        resolve would bring the discarded accumulation back."""
        owner = self.__dict__.get("_inflight_collection")
        if owner is not None:
            owner._cancel_overlap()
        round_ = self.__dict__.get("_inflight")
        if round_ is not None:
            object.__setattr__(self, "_inflight", None)
            drain_round(round_, timeout=self.sync_timeout)
            self._sync_stats_dict()["cancelled"] += 1
        self._group_detach_if_stray()
        self._update_called = False
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        # fresh copies: a subclass that updates in place must not write into
        # the defaults (forward, on the hot path, aliases them instead)
        self._restore({k: self._default_value(k) for k in self._defaults})
        self._is_synced = False
        self._sync_degraded = False
        self._cache = None

    def clone(self) -> "Metric":
        """Deep copy."""
        return deepcopy(self)

    def with_capacity(self, capacity: int) -> "Metric":
        """Turn every list ("cat") state into a
        :class:`~metrics_tpu_torch.core.cat_buffer.CatBuffer` of ``capacity``
        rows: one preallocated tensor per state, filled in place, instead of
        a list of batches concatenated at ``compute()``. The curve metrics
        then compute over the buffer with padding-aware ranking
        (``ops/ranking.py``). Allowed before the first update, or to resize
        buffers that are still empty. Returns ``self``.
        """
        self._group_detach_if_stray()
        self._drop_programs()
        for name, default in self._defaults.items():
            live = getattr(self, name)
            if isinstance(default, list):
                if isinstance(live, list) and live:
                    raise MetricsTPUUserError(
                        "with_capacity() must be called before any update() "
                        f"(state {name!r} already holds data)."
                    )
            elif isinstance(default, CatBuffer):
                if (isinstance(live, CatBuffer) and len(live)) or len(default):
                    raise MetricsTPUUserError(
                        "with_capacity() cannot resize a CatBuffer state that "
                        f"already holds data (state {name!r})."
                    )
            else:
                continue
            self._defaults[name] = CatBuffer(capacity)
            setattr(self, name, CatBuffer(capacity))
        return self

    def enable_check_finite(self) -> "Metric":
        """Turn on NaN/Inf screening; returns ``self``.

        Registers the hidden ``_nonfinite`` poison-flag state (an int32
        scalar, ``dist_reduce_fx="sum"``) and screens every later ``update``
        at O(batch) cost, with no host read: the update's float inputs, the
        tensor states and the list entries it appended latch the flag
        (CatBuffer bodies are scanned once at the sync and compute boundary
        instead). A poisoned rank then fails a sync on every rank with
        :class:`~metrics_tpu_torch.utils.exceptions.NonFiniteStateError`
        (the health header carries the verdict), and a single process fails
        its ``compute()``. Must be called before the first ``update``.
        """
        if NONFINITE_STATE not in self._defaults:
            if self._update_called:
                raise MetricsTPUUserError(
                    "enable_check_finite() must be called before the first "
                    "update(): the poison flag must cover the whole accumulation."
                )
            self._group_detach_if_stray()  # a schema change: leave the group
            self.add_state(NONFINITE_STATE, torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.check_finite = True
        return self

    # ------------------------------------------------------------------
    # pure state API
    # ------------------------------------------------------------------

    @property
    def state_names(self) -> List[str]:
        """The declared states, in declaration order."""
        return list(self._defaults)

    def init_state(self) -> Dict[str, Any]:
        """A fresh state dict: the declared defaults, on storage of their own."""
        return {k: self._default_value(k) for k in self._defaults}

    def pure_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Functional update: ``state -> new state``. Touches neither the
        instance's state nor its update count, leaves ``state`` unchanged
        (a CatBuffer is copied on write) and keeps the autograd graph: the
        gradient contract runs through ``pure_update`` → :meth:`pure_compute`."""
        d = self.__dict__
        saved = self._raw_state()
        saved_flags = (self._update_count, self._update_called, self._computed, d.get("_pure_mode", False))
        # inside a compiled program the state is the program's own slot,
        # which its CatBuffers append to in place
        program = in_program()
        object.__setattr__(self, "_pure_mode", True)
        try:
            for name, v in state.items():
                _set_state(self, name, v if program and isinstance(v, CatBuffer) else _pure_copy(v))
            self.update(*args, **kwargs)
            return self._raw_state()
        finally:
            for name, v in saved.items():
                _set_state(self, name, v)
            self._update_count, self._update_called, self._computed, pure = saved_flags
            object.__setattr__(self, "_pure_mode", pure)

    def pure_compute(self, state: Dict[str, Any]) -> Any:
        """Functional compute over an explicit state dict (no sync, no cache,
        no compute-before-update warning)."""
        d = self.__dict__
        saved = self._raw_state()
        saved_flags = (self._computed, d.get("_pure_mode", False))
        object.__setattr__(self, "_pure_mode", True)
        try:
            for name, v in state.items():
                _set_state(self, name, v)
            self._computed = None
            return self.compute()
        finally:
            for name, v in saved.items():
                _set_state(self, name, v)
            self._computed, pure = saved_flags
            object.__setattr__(self, "_pure_mode", pure)

    def pure_sync(self, state: Dict[str, Any], axis_name: Optional[Any] = None, fused: bool = False) -> Dict[str, Any]:
        """Cross-process sync of an explicit state with in-program collectives
        (``parallel/sync.py::sync_in_jit``), which a CUDA graph over an NCCL
        group or ``torch.compile`` can hold and gloo runs on the CPU.

        ``axis_name`` (default: the constructor's ``process_group``) is a
        ``ProcessGroup``, a ``DeviceMesh``, ``(DeviceMesh, dim or dims)`` or
        a list of ranks; syncing over one dim of a 2-D mesh leaves one
        value per slice of the other. ``fused=True`` reduces each
        ``(dtype, fx)`` bucket of reduce states in one collective (the same
        values). No health header runs here: every rank must pass the same
        schema.
        """
        if axis_name is None:
            axis_name = self.process_group
        if axis_name is None:
            raise MetricsTPUUserError(
                "pure_sync needs a mesh axis or process group: pass `axis_name=` or construct the metric "
                "with `process_group=<group>`."
            )
        return _sync.sync_in_jit(state, self._reductions, axis_name, fused=fused)

    def pure_forward(self, state: Dict[str, Any], *args: Any, axis_name: Optional[Any] = None, **kwargs: Any) -> Any:
        """One functional step: ``(new_state, batch_value)``, the batch value
        from the batch alone, as :meth:`forward` returns it, synced over
        ``axis_name`` (default: the constructor's ``process_group``) when
        there is one."""
        if axis_name is None:
            axis_name = self.process_group
        batch_state = self.pure_update(self.init_state(), *args, **kwargs)
        value_state = self.pure_sync(batch_state, axis_name) if axis_name is not None else batch_state
        value = self.pure_compute(value_state)
        return self.merge_states(state, batch_state), value

    def compiled_step(
        self, state: Dict[str, Any], *args: Any, axis_name: Optional[Any] = None, **kwargs: Any
    ) -> Tuple[Dict[str, Any], Any]:
        """The whole step as one program: ``pure_update``, the in-program
        fused sync over ``axis_name`` when given, ``pure_compute``.

        Returns ``(new_state, value)``, the value over the accumulated (and
        synced) state, what ``sync(); compute()`` would serve. On the card
        one CUDA graph a step; thread ``new_state`` back in (it is the
        program's own state buffers) and never reuse the state passed in.
        Inside your own capture or ``torch.compile`` it runs inline. See
        ``core/plan.py::compiled_step`` (``METRICS_TPU_UNIFIED_PLAN=0`` runs
        the separate phases).
        """
        return plan_mod.compiled_step(self, state, args, kwargs, axis_name=axis_name)

    # ------------------------------------------------------------------
    # compiled hot path (core/compiled.py)
    # ------------------------------------------------------------------

    def _compiled_dispatcher(self) -> CompiledDispatcher:
        disp = self.__dict__.get("_compiled")
        if disp is None:
            disp = CompiledDispatcher(type(self).__name__, registry_of(self).domain("compile"), plan_mod.binding(self))
            object.__setattr__(self, "_compiled", disp)
        return disp

    def _drop_programs(self) -> None:
        """Forget every program and slot (they read this metric's buffers by
        address); counters and fallbacks stay."""
        disp = self.__dict__.get("_compiled")
        if disp is not None:
            disp.slots.clear()
        b = plan_mod.peek_binding(self)
        if b is not None:
            b.programs.clear()

    def _nested_metric_attrs(self) -> List[str]:
        """Attributes holding other metrics (one container level deep):
        wrappers and compositions whose ``update`` delegates eagerly."""
        out: List[str] = []
        for k, v in list(self.__dict__.items()) + list(self._modules.items()):
            if isinstance(v, Metric):
                out.append(k)
            elif isinstance(v, (list, tuple)) and any(isinstance(x, Metric) for x in v):
                out.append(k)
            elif isinstance(v, dict) and any(isinstance(x, Metric) for x in v.values()):
                out.append(k)
        return out

    def _compiled_static_fallback(self, kind: str) -> Optional[str]:
        """Statically known reasons ``kind`` never compiles for this instance
        (``None``: none; the probe still has the last word). Documented design
        exclusions: marking them emits no diagnostic."""
        if not self._defaults:
            return "metric declares no states (update composes or delegates; nothing to compile)"
        shared = type(self)._group_shared_attrs
        if shared:
            return (
                f"update maintains declared side-effect attribute(s) {shared} "
                "(input-mode / inferred-num_classes latch) that a compiled "
                "replay would skip"
            )
        for name, default in self._defaults.items():
            if isinstance(default, list):
                return (
                    f"list state {name!r} grows every step and would retrace every "
                    "step — use with_capacity() for a fixed-shape CatBuffer"
                )
        nested = self._nested_metric_attrs()
        if nested:
            return f"instance holds nested Metric attribute(s) {nested}; update may delegate to them"
        if kind == "forward":
            if not self._can_merge():
                return "forward uses the non-mergeable double-update replay"
            if self.dist_sync_on_step:
                return "dist_sync_on_step runs a host sync between update and compute"
            if self.check_finite:
                return (
                    "check_finite raises eagerly at forward's compute step; only "
                    "the inner update compiles"
                )
        return None

    def _compiled_gate(self, kind: str) -> Optional[CompiledDispatcher]:
        """The cheap gate of one eager dispatch: the dispatcher when the
        compiled path should be tried, else ``None``. Counts the warm-up steps
        for ``kind == "update"`` (forward's inner eager update counts its
        step)."""
        knob = self.compiled_update
        if knob is False or not compiled_update_enabled():
            return None
        if self.__dict__.get("_pure_mode", False) or in_program():
            return None
        disp = self._compiled_dispatcher()
        if kind == "update":
            disp.steps_seen += 1
        if kind in disp.fallback:
            return None
        if knob is not True and disp.steps_seen <= compiled_warmup():
            return None
        if not self._compiled_static_ok(kind, disp):
            return None
        return disp

    def _compiled_static_ok(self, kind: str, disp: CompiledDispatcher) -> bool:
        """:meth:`_compiled_static_fallback`, once per (instance, kind)."""
        marker = ("static_ok", kind)
        if disp.probed(marker):
            return True
        reason = self._compiled_static_fallback(kind)
        if reason is not None:
            disp.mark_fallback(kind, reason, warn=False)
            return False
        disp.mark_probed(marker)
        return True

    def _program_fn(self, kind: str, treedef: Any, dyn_ix: Tuple[int, ...], statics: Tuple) -> Callable:
        """The function a program runs: ``(state, dynamic) -> (new state,
        batch value)``, the eager computation through the pure API."""
        if kind == "update":

            def fn(state: Dict[str, Any], dyn: List[torch.Tensor]) -> Tuple[Dict[str, Any], Any]:
                a, kw = rebuild_call(treedef, dyn_ix, statics, dyn)
                return self.pure_update(state, *a, **kw), None

        else:

            def fn(state: Dict[str, Any], dyn: List[torch.Tensor]) -> Tuple[Dict[str, Any], Any]:
                a, kw = rebuild_call(treedef, dyn_ix, statics, dyn)
                batch = self.pure_update(self._batch_default_state(), *a, **kw)
                value = self.pure_compute(batch)
                return self._forward_merge(state, batch), value

        return fn

    def _program_inputs(self, disp: CompiledDispatcher, args: Tuple, kwargs: Dict[str, Any], kind: str):
        """``(skeleton key, dynamic, state signature)`` of one call, or
        ``None`` when this call stays eager (its kind fell back, or its state
        or inputs are not a program's: a list state, a CatBuffer not yet
        materialized, an input on another device)."""
        try:
            treedef, dyn_ix, statics, dynamic = split_call(args, kwargs)
        except TypeError:
            disp.mark_fallback(kind, f"{kind} arguments contain unhashable non-array values")
            return None
        if any(t.device != self._device for t in dynamic):
            return None
        state = self._raw_state()
        sig = state_signature(state)
        if sig is None or any(_is_weak(v) for v in state.values()):
            return None  # a weakly typed default takes its dtype in an eager step first
        return (kind, treedef, dyn_ix, statics), dynamic, sig

    def _state_in(self, slot: Dict[str, Any]) -> None:
        """Bring the metric's current state into a program's slot (when the
        latch is clear, the state lives elsewhere) and seed the device-side
        CatBuffer offsets from the host counts."""
        if self.__dict__.get("_donation_ready", False):
            return
        for name, v in self._raw_state().items():
            target = slot[name]
            if isinstance(target, CatBuffer):
                if v is not target:
                    target.buffer.copy_(v.buffer)
                    target.count, target.overflowed = v.count, v.overflowed
                target._offset.fill_(target.count)
            elif v is not target:
                target.copy_(v)

    def _bind_slot(self, slot: Dict[str, Any]) -> None:
        """After a dispatch: the metric's states are the slot (latch set)."""
        for name, v in slot.items():
            _set_state(self, name, v)
        plan_mod.mark_donation_ready(self)

    def _compiled_dispatch(self, kind: str, args: Tuple, kwargs: Dict[str, Any]) -> Tuple[bool, Any]:
        """Run one eager ``update``/``forward`` as one program. Returns
        ``(handled, batch_value)``; ``handled=False`` sends the caller down the
        eager path. The program is the eager computation: ``pure_update``
        (checks skipped, dtype persistence and screening included), and for
        ``forward`` the batch ``pure_compute`` and the merge."""
        disp = self._compiled_dispatcher()
        if disp.storming(kind):
            return False, None
        inputs = self._program_inputs(disp, args, kwargs, kind)
        if inputs is None:
            return False, None
        skey, dynamic, sig = inputs
        fn = self._program_fn(kind, *skey[1:])
        if not disp.probed(skey):
            verdict, detail = consult_static([(self, ("update",) if kind == "update" else ("update", "compute", "merge"))])
            if verdict == "dirty":
                disp.mark_fallback(kind, detail)
                return False, None
            if verdict != "clean":
                reason = probe_traceable(fn, self._raw_state(), dynamic, [self])
                if reason is not None:
                    disp.mark_fallback(kind, reason)
                    return False, None
            disp.mark_probed(skey)
        slot = disp.slot(sig, self._raw_state())
        self._state_in(slot)
        key = skey + (tensor_signature(dynamic), sig, self._dtype)
        try:
            prog = disp.program(
                key, lambda: Program.build(fn, slot, [(slot, None)], dynamic, self._device, disp.pool(self._device)))
        except CaptureError as err:
            disp.mark_fallback(kind, f"compiled dispatch failed ({err})")
            return False, None
        if prog is None:
            return False, None
        value = dispatch_program(disp, kind, prog, dynamic)
        self._bind_slot(slot)
        _raise_on_catbuffer_overflow(slot, type(self).__name__)
        return True, value

    def _maybe_compiled_update(self, args: Tuple, kwargs: Dict[str, Any]) -> bool:
        """The compiled path of one eager ``update`` (called by the update
        wrapper with the bookkeeping done)."""
        if self._compiled_gate("update") is None:
            return False
        return self._compiled_dispatch("update", args, kwargs)[0]

    def _maybe_compiled_forward(self, args: Tuple, kwargs: Dict[str, Any]) -> Tuple[bool, Any]:
        """The compiled path of one ``forward``: update + batch compute +
        merge in one program. Returns ``(handled, batch_value)``."""
        if self._compiled_gate("forward") is None:
            return False, None
        # as the eager path: a stray forward on a grouped member detaches
        # first, and the metric counts as updated before the batch compute
        self._group_detach_if_stray()
        self._update_called = True
        handled, value = self._compiled_dispatch("forward", args, kwargs)
        if not handled:
            return False, None
        self._update_count += 1
        self._computed = None
        self._forward_cache = value
        _fire_checkpointer(self)
        return True, value

    # ------------------------------------------------------------------
    # compute-group protocol (MetricCollection state/update dedup)
    # ------------------------------------------------------------------

    def state_fingerprint(self) -> Tuple:
        """The declared state schema: every state's name, kind (tensor / list
        / CatBuffer), dtype, shape, reduction and reset default's bytes. Equal
        fingerprints are the first condition for two collection members to
        share state; an equal :meth:`update_identity` is the second."""
        parts: List[Tuple] = []
        for name in sorted(self._defaults):
            default = self._defaults[name]
            fx = self._reductions[name]
            # callables compare by identity: two functions may reduce
            # differently even when their names collide
            fx_tag: Any = ("callable", id(fx)) if callable(fx) and not isinstance(fx, str) else fx
            if isinstance(default, list):
                parts.append((name, "list", fx_tag))
            elif isinstance(default, CatBuffer):
                item = None if default.buffer is None else (
                    str(default.buffer.dtype), tuple(default.buffer.shape[1:]))
                parts.append((name, "catbuf", default.capacity, item, fx_tag))
            else:
                host = default.detach().cpu().contiguous()
                # raw bytes through uint8: numpy has no bfloat16
                raw = host.reshape(-1).view(torch.uint8).numpy().tobytes()
                parts.append((name, "leaf", str(host.dtype), tuple(host.shape), raw, fx_tag))
        return tuple(parts)

    def update_identity(self) -> Optional[Tuple]:
        """A hashable key naming what this metric's ``update`` does to its
        state, or ``None`` (the default): no claim, never shares updates.

        Families whose members run the same ``update`` with the same
        configuration declare one (the stat-score family, the curve family).
        Members of a ``MetricCollection`` with equal keys and equal
        :meth:`state_fingerprint` form a compute group: one update, one copy
        of state. A family whose update writes instance attributes lists them
        in ``_group_shared_attrs``.
        """
        return None

    def _effective_update_identity(self) -> Optional[Tuple]:
        """The identity key, or ``None`` for a subclass that overrides
        ``update`` without declaring its own key (the inherited key speaks of
        the base class's update)."""
        cls = type(self)
        ident_cls = next(c for c in cls.__mro__ if "update_identity" in c.__dict__)
        if ident_cls is Metric:
            return None
        upd_cls = next((c for c in cls.__mro__ if "update" in c.__dict__), None)
        if upd_cls is not None and cls.__mro__.index(upd_cls) < cls.__mro__.index(ident_cls):
            return None
        return self.update_identity()

    def _group_detach_if_stray(self) -> None:
        """Copy-on-write detach from a compute group on an out-of-group state
        mutation (a direct ``update``, ``forward``, ``reset``, load, cast or
        state assignment on one member): the member takes a clone of every
        state leaf and leaves the group, so its siblings never see it.
        Operations the collection dispatches to the group pass through.

        The clone is of every leaf, not only of the containers as in the JAX
        package (whose arrays are immutable): here ``forward`` merges into
        the accumulation's CatBuffers in place."""
        group = self.__dict__.get("_compute_group")
        if group is None or group.dispatching:
            return
        group.members[:] = [m for m in group.members if m is not self]
        object.__setattr__(self, "_compute_group", None)
        if journal.ACTIVE:
            journal.record(
                "group.detach", label=type(self).__name__, step=self._update_count, remaining=len(group.members),
            )
        for k, v in self._state.items():
            nn.Module.__setattr__(self, k, _fresh_state_value(v))
        if len(group.members) < 2:
            for m in group.members:
                object.__setattr__(m, "_compute_group", None)
            group.members.clear()

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------

    def checkpointer(
        self,
        directory: str,
        *,
        every_n_updates: int = 1,
        keep_last: Optional[int] = None,
        rank: Optional[int] = None,
        world: Optional[int] = None,
    ) -> Any:
        """Context manager: periodic preemption-safe snapshots from ``update``.

        While the context is active, every ``every_n_updates``-th
        ``update``/``forward`` atomically snapshots this metric's rank-local
        state into ``directory`` (``core/checkpoint.py``: CRC-verified
        manifest, write-temp → fsync → rename, ``keep_last`` retention), and
        a clean exit flushes the tail. Resume with
        :func:`~metrics_tpu_torch.core.checkpoint.load_checkpoint`, at the same
        world size or elastically at another.
        """
        from metrics_tpu_torch.core.checkpoint import MetricCheckpointer

        return MetricCheckpointer(
            self, directory, every_n_updates=every_n_updates, keep_last=keep_last, rank=rank, world=world
        )

    def persistent(self, mode: bool = False) -> None:
        """Set whether every state is written by ``state_dict()``."""
        for name in self._persistent:
            self._persistent[name] = mode

    def _save_to_state_dict(self, destination: Dict[str, Any], prefix: str, keep_vars: bool) -> None:
        # nn.Module.state_dict() calls this for every module of a tree, so a
        # Metric nested in a model or a MetricCollection writes its states.
        # An in-flight round resolves first (the "next read"): the snapshot is
        # the synced view, as sync -> state_dict -> unsync gives
        owner = self.__dict__.get("_inflight_collection")
        if owner is not None:
            owner._resolve_member_request(self)
        if self.__dict__.get("_inflight") is not None and not self._is_synced:
            self._resolve_overlap()
        for name in self._defaults:
            if not self._persistent[name]:
                continue
            v = getattr(self, name)
            if isinstance(v, CatBuffer):
                # the JAX package's snapshot layout; the buffer is a copy, so
                # later appends cannot write into the snapshot
                destination[prefix + name] = {
                    "__catbuffer__": v.capacity,
                    "buffer": None if v.buffer is None else v.buffer.detach().clone(),
                    "count": torch.tensor(v.count),
                    "overflowed": torch.tensor(v.overflowed),
                }
            elif isinstance(v, list):
                destination[prefix + name] = [x if keep_vars else x.detach() for x in v]
            else:
                destination[prefix + name] = v if keep_vars else v.detach()

    def _load_from_state_dict(
        self,
        state_dict: Dict[str, Any],
        prefix: str,
        local_metadata: Dict[str, Any],
        strict: bool,
        missing_keys: List[str],
        unexpected_keys: List[str],
        error_msgs: List[str],
    ) -> None:
        self._group_detach_if_stray()
        for name in self._defaults:
            key = prefix + name
            if key in state_dict:
                loaded = self._loaded_state(key, state_dict[key], self._defaults[name])
                setattr(self, name, loaded)
                self._update_called = True
                # the loaded state supersedes any memoized result
                self._computed = None
                self._forward_cache = None
            elif strict and self._persistent[name]:
                missing_keys.append(key)
        if strict:
            for key in state_dict:
                if key.startswith(prefix) and key[len(prefix):] not in self._defaults and "." not in key[len(prefix):]:
                    unexpected_keys.append(key)

    def _loaded_state(self, key: str, v: Any, declared: Any) -> Any:
        """One snapshot value as a state of this metric's declared kind: a
        CatBuffer snapshot (or a CatBuffer, from ``utils/convert.py``) may
        resume a list state and a list snapshot a CatBuffer state, as in the
        JAX package. A CatBuffer state keeps its declared capacity and gets
        storage of its own."""
        if isinstance(v, dict) and "__catbuffer__" in v:
            buffer = v["buffer"]
            v = CatBuffer(
                v["__catbuffer__"],
                None if buffer is None else torch.as_tensor(buffer),
                int(v["count"]),
                # absent in snapshots from before the overflow flag: clean
                bool(v.get("overflowed", False)),
            )
        if isinstance(v, CatBuffer):
            if isinstance(declared, CatBuffer):
                cb = CatBuffer(declared.capacity)
                if v.count:
                    cb.append(v.buffer[: v.count].to(self._device))
                cb.overflowed = v.overflowed
                return cb
            # a list state has no overflow flag to carry, so a corrupt
            # (overflowed) snapshot must fail the load
            if v.overflowed:
                raise MetricsTPUUserError(
                    f"Checkpoint state '{key}' holds a CatBuffer that "
                    "overflowed inside jit: its rows are corrupt and "
                    "cannot be resumed into a list-state metric. "
                    "Re-run the accumulation with a larger capacity."
                )
            return [v.values().to(self._device)] if len(v) else []
        if isinstance(v, list):
            rows = [torch.as_tensor(x).to(self._device) for x in v]
            if isinstance(declared, CatBuffer):
                cb = CatBuffer(declared.capacity)
                for x in rows:
                    cb.append(x)
                return cb
            return rows
        return torch.as_tensor(v).to(self._device)

    def load_state_dict(  # type: ignore[override]
        self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = False
    ) -> None:
        """Resume accumulated state from a ``state_dict`` snapshot.

        By default declared states absent from the snapshot are skipped. With
        ``strict=True`` the key sets must match exactly, or a
        :class:`StateDictMismatchError` listing every missing and unexpected
        key is raised before any state changes.
        """
        if strict:
            declared = {prefix + name for name in self._defaults}
            present = {k for k in state_dict if not prefix or k.startswith(prefix)}
            missing = sorted(declared - set(state_dict))
            unexpected = sorted(present - declared)
            if missing or unexpected:
                raise StateDictMismatchError(
                    f"load_state_dict(strict=True) for {type(self).__name__}: "
                    f"missing keys {missing}, unexpected keys {unexpected}. "
                    "Nothing was loaded."
                )
        self._load_from_state_dict(state_dict, prefix, {}, False, [], [], [])

    # ------------------------------------------------------------------
    # kwarg filtering (MetricCollection broadcasts a superset of kwargs)
    # ------------------------------------------------------------------

    def _filtered_kwargs(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Keep only the kwargs this metric's ``update`` accepts."""
        if not kwargs:
            return kwargs
        names = self.__dict__.get("_update_kwarg_names")
        if names is None:  # the signature is inspected once per instance
            params = inspect.signature(self.update).parameters
            names = True if any(p.kind == p.VAR_KEYWORD for p in params.values()) else frozenset(params)
            self._update_kwarg_names = names
        if names is True:
            return kwargs
        return {k: v for k, v in kwargs.items() if k in names}

    # ------------------------------------------------------------------
    # identity and operator composition
    # ------------------------------------------------------------------

    def __hash__(self) -> int:
        return id(self)

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_div, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_div, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_floordiv, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_floordiv, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_mod, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_mod, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(_eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(_ne, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_ge, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(_abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        # abs, not identity, as in the JAX package (and upstream TorchMetrics)
        return CompositionalMetric(_abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(_logical_not, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(functools.partial(_getitem, idx=idx), self, None)


def _wrap_update(update: Callable) -> Callable:
    @functools.wraps(update)
    def wrapped_func(self: Metric, *args: Any, **kwargs: Any) -> None:
        if self._is_synced:
            raise MetricsTPUUserError(
                "The Metric shouldn't be synced when performing ``update``. "
                "HINT: Did you forget to call ``unsync``?"
            )
        d = self.__dict__
        if d.get("_pure_mode", False):
            # the pure API (and a compiled program through it): an explicit
            # state, no bookkeeping, the caller's grad mode
            return _run_update(self, update, args, kwargs)
        # a direct update on one member of a compute group leaves the group
        # before it mutates anything shared
        self._group_detach_if_stray()
        self._computed = None
        self._update_called = True
        self._update_count += 1
        if self._maybe_compiled_update(args, kwargs):
            # one program ran the whole update; only the host hooks remain
            if not d.get("_ckpt_suppress", False):
                _fire_checkpointer(self)
            return None
        if d.get("_donation_ready", False):
            self._release_compiled_state("eager-update")
        # the running states never keep the graph (a list state's entry is
        # the caller's tensor: detached); forward's batch update keeps it for
        # a differentiable metric's batch value (_grad_batch)
        if d.get("_grad_batch", False):
            out = _run_update(self, update, args, kwargs)
        else:
            lens = {name: len(v) for name, v in self._raw_state().items() if isinstance(v, list)}
            with torch.no_grad():
                out = _run_update(self, update, args, kwargs)
            for name, n in lens.items():
                v = self._raw_state()[name]
                if any(isinstance(x, torch.Tensor) and x.requires_grad for x in v[n:]):
                    _set_state(self, name, v[:n] + _detached(v[n:]))
        if not d.get("_ckpt_suppress", False):
            # periodic durability (Metric.checkpointer); forward suppresses
            # this for its batch-state update and fires once it has merged
            _fire_checkpointer(self)
        return out

    wrapped_func._wrapped = True  # type: ignore[attr-defined]
    return wrapped_func


def _run_update(self: Metric, update: Callable, args: Tuple, kwargs: Dict[str, Any]) -> Any:
    """The update body with what every update carries: the weak-dtype
    adoption, ``set_dtype``'s re-cast, the ``check_finite`` screen and the
    overflow check of a loaded CatBuffer."""
    if type(self)._weak_dtype_states:
        state = self._raw_state()
        adopted = self._adopt_weak_dtypes(state, (args, kwargs))
        if adopted is not state:
            self._restore(adopted)
    screening = self.check_finite and NONFINITE_STATE in self._defaults
    if screening:
        # the screen covers only the list entries this update appends
        prev_list_lens = {name: len(v) for name, v in self._raw_state().items() if isinstance(v, list)}
    out = update(self, *args, **kwargs)
    if self._dtype is not None:
        self._restore(_cast_floating(self._raw_state(), self._dtype))
    if screening:
        # latch, never clear; fx="sum" carries the flag through merges
        flag = _update_nonfinite_flag(self._raw_state(), (args, kwargs), prev_list_lens, self._device)
        self._restore({NONFINITE_STATE: torch.maximum(self._raw_state()[NONFINITE_STATE], flag)})
    _raise_on_catbuffer_overflow(self._raw_state(), type(self).__name__)
    return out


def _wrap_compute(compute: Callable) -> Callable:
    @functools.wraps(compute)
    def wrapped_func(self: Metric, *args: Any, **kwargs: Any) -> Any:
        d = self.__dict__
        pure = d.get("_pure_mode", False)
        if not self._update_called and not pure:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before "
                "the ``update`` method which may lead to errors, as metric states have not "
                "yet been updated.",
                UserWarning,
            )
        if self._computed is not None:
            return self._computed
        if d.get("_donation_ready", False) and not pure:
            # a value may be a view of a state: it must not see later replays
            self._release_compiled_state("compute")
        should = self._to_sync and not self._is_synced and not pure
        screening = self.check_finite and NONFINITE_STATE in self._defaults and not in_program()
        if screening and not self._distributed_available() and state_poisoned(self._raw_state()):
            # one process: refuse here (in a world, the sync header raises on
            # every rank together instead; raising before it would strand
            # the healthy ranks in their gather)
            raise NonFiniteStateError(
                f"{type(self).__name__} accumulated non-finite (NaN/Inf) state values "
                "(check_finite screening); compute() refused rather than returning a "
                "silently-corrupt result."
            )
        with self.sync_context(dist_sync_fn=self.dist_sync_fn, should_sync=should, should_unsync=should):
            if screening and self._is_synced and int(getattr(self, NONFINITE_STATE)) > 0:
                # a custom dist_sync_fn runs no header, but the flag rides its
                # transport (fx="sum"): every rank sees the same sum and raises
                raise NonFiniteStateError(
                    f"{type(self).__name__}: a participating process accumulated non-finite "
                    "(NaN/Inf) state values (check_finite screening; poison flag gathered "
                    "through the sync transport)."
                )
            self._computed = compute(self, *args, **kwargs)
        return self._computed

    wrapped_func._wrapped = True  # type: ignore[attr-defined]
    return wrapped_func


class CompositionalMetric(Metric):
    """Lazy arithmetic over metrics, built by the operator overloads of
    :class:`Metric`: ``2 * (p * r) / (p + r)`` is a metric whose ``update``
    feeds both operands and whose ``compute`` applies the operators to their
    values. Counterpart of the JAX package's ``CompositionalMetric``.

    An operand that appears at several places of the tree is updated once per
    place, as in the JAX package. The composite lives where its metric
    operands live (they must agree); constant operands become tensors there,
    and ``.to()`` moves both, since operands are submodules and constants
    buffers.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision, Recall
        >>> p, r = Precision(device="cpu"), Recall(device="cpu")
        >>> f1 = 2 * (p * r) / (p + r)
        >>> _ = f1(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 0, 0, 1]))
        >>> round(float(f1.compute()), 4)
        0.75
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, torch.Tensor],
        metric_b: Union[Metric, float, int, torch.Tensor, None],
    ) -> None:
        devices = {m.device for m in (metric_a, metric_b) if isinstance(m, Metric)}
        if len(devices) > 1:
            raise ValueError(
                f"The operands of a CompositionalMetric live on different devices: {sorted(map(str, devices))}"
            )
        super().__init__(device=devices.pop() if devices else None)
        self.op = operator
        for name, operand in (("metric_a", metric_a), ("metric_b", metric_b)):
            if isinstance(operand, Metric):
                setattr(self, name, operand)
            else:
                constant = None if operand is None else torch.as_tensor(operand, device=self.device)
                self.register_buffer(name, constant, persistent=False)

    def update(self, *args: Any, **kwargs: Any) -> None:
        for operand in (self.metric_a, self.metric_b):
            if isinstance(operand, Metric):
                operand.update(*args, **operand._filtered_kwargs(kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a, val_b = (
            operand(*args, **operand._filtered_kwargs(kwargs)) if isinstance(operand, Metric) else operand
            for operand in (self.metric_a, self.metric_b)
        )
        # the operands accumulated; a later compute() must neither warn nor
        # return a stale value
        self._update_called = True
        self._computed = None
        if val_a is None:
            return None
        if val_b is None:
            if isinstance(self.metric_b, Metric):
                return None
            self._forward_cache = self.op(val_a)
            return self._forward_cache
        self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        super().reset()
        for operand in (self.metric_a, self.metric_b):
            if isinstance(operand, Metric):
                operand.reset()

    def persistent(self, mode: bool = False) -> None:
        for operand in (self.metric_a, self.metric_b):
            if isinstance(operand, Metric):
                operand.persistent(mode)

    def __repr__(self) -> str:
        op = getattr(self.op, "__name__", "op")
        return f"{type(self).__name__}(\n  {op}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"
