"""The compiled hot path: CUDA-graph replay of ``update``/``forward``.

Counterpart of ``metrics_tpu/core/compiled.py``. The eager surface pays one
kernel launch per torch op of ``update()`` and a host read per value check;
a metric step on the card is host-bound by them. After a warm-up of eager
steps, every eligible metric's ``update``/``forward`` (and every eligible
member of a ``MetricCollection``, in one program a step) runs as one cached
program:

- **On a CUDA tensor** the program is a ``torch.cuda.CUDAGraph``, captured
  once per (kind, call skeleton, input and state signature) over static
  input buffers and the metric's static state buffers (its *slot*). The
  capture records ``pure_update`` in program mode (value checks skipped, a
  CatBuffer appending at a device-side offset) and the in-place write-back of
  the new state into the slot. A step copies the inputs into the static
  buffers and replays; the host bookkeeping (update count, ``_computed``,
  the checkpointer hook, CatBuffer fill counts, kernel launch counts) runs as
  eager runs it.
- **On a CPU tensor** the program is the same program-mode function called
  directly, so that the CPU tests run the code the card captures.

Before its first capture a program runs once eagerly, on a copy of the
state, with every value check on: bad input raises there, as in eager, and
the card's libraries initialise outside the capture.

Knobs, read from the JAX package's environment variables:
``METRICS_TPU_COMPILED_UPDATE=0`` turns the path off process-wide
(``Metric.compiled_update = False`` per metric, ``True`` skips the warm-up);
``METRICS_TPU_COMPILED_WARMUP`` (16) eager steps come first;
``METRICS_TPU_COMPILED_TRACE_WARN`` (8) captures warn of shape churn, and
four times as many mark the storm that sends an instance to eager for good.

:func:`probe_traceable` is the counterpart of ``jax.eval_shape``: a dry run
under ``FakeTensorMode`` that catches data-dependent host reads and output
shapes, and instance-attribute side effects the replay would skip. A capture
or replay that fails with the state intact falls back to eager for that
kind, for good, with a one-time diagnostic and an entry in
``compile_stats()["fallback"]``.

The contract is **compiled ≡ eager, leaf for leaf, bit for bit**: a replay
runs the kernels eager runs, in the same order.
"""
import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.observability import diagnostics, journal

__all__ = [
    "COMPILED_UPDATE_ENV",
    "CaptureError",
    "COMPILED_WARMUP_ENV",
    "TRACE_WARN_ENV",
    "CompiledDispatcher",
    "Program",
    "compile_stats_view",
    "compiled_update_enabled",
    "compiled_warmup",
    "consult_static",
    "in_program",
    "program_context",
    "probe_traceable",
    "rebuild_call",
    "split_call",
    "trace_storm_threshold",
    "trace_warn_threshold",
]

#: Env escape hatch: 0/false/off/no disables the compiled path process-wide.
COMPILED_UPDATE_ENV = "METRICS_TPU_COMPILED_UPDATE"

#: Eager steps an instance observes before its first capture (default 16).
COMPILED_WARMUP_ENV = "METRICS_TPU_COMPILED_WARMUP"

#: Capture count at which the shape-churn diagnostic fires (default 8).
TRACE_WARN_ENV = "METRICS_TPU_COMPILED_TRACE_WARN"


def compiled_update_enabled() -> bool:
    """Default policy: on, unless the env knob opts the process out."""
    return os.environ.get(COMPILED_UPDATE_ENV, "1").strip().lower() not in ("0", "false", "off", "no")


def compiled_warmup() -> int:
    try:
        return int(os.environ.get(COMPILED_WARMUP_ENV, "16"))
    except ValueError:
        return 16


def trace_warn_threshold() -> int:
    try:
        return int(os.environ.get(TRACE_WARN_ENV, "8"))
    except ValueError:
        return 8


def trace_storm_threshold() -> int:
    """Captures at which an instance gives up on compiling (4x the warn
    threshold): every new signature costs a probe, an eager warm-up and a
    capture, and the program cache would grow without bound."""
    return 4 * trace_warn_threshold()


def compile_stats_view(stats: Dict[str, Any]) -> Dict[str, Any]:
    """The public ``compile_stats()`` shape of a ``compile`` domain
    (``observability/registry.py``): raw counters pass through,
    ``cache_hits`` is dispatches minus traces, an empty fallback map reads as
    ``None``."""
    fallback = stats.get("fallback")
    return {
        "traces": stats.get("traces", 0),
        "dispatches": stats.get("dispatches", 0),
        "cache_hits": max(stats.get("dispatches", 0) - stats.get("traces", 0), 0),
        "steps_seen": stats.get("steps_seen", 0),
        "fallback": dict(fallback) if fallback else None,
    }


# ---------------------------------------------------------------------------
# program mode: the traced counterpart of running under jit
# ---------------------------------------------------------------------------

_MODE = threading.local()


def in_program() -> bool:
    """True while a compiled program runs, is captured or is probed on this
    thread: value checks are skipped (``utils/checks.py::_is_concrete``) and
    a CatBuffer appends at its device-side offset."""
    return getattr(_MODE, "depth", 0) > 0


@contextmanager
def program_mode() -> Iterator[None]:
    _MODE.depth = getattr(_MODE, "depth", 0) + 1
    try:
        yield
    finally:
        _MODE.depth -= 1


@contextmanager
def _building() -> Iterator[None]:
    _MODE.building = getattr(_MODE, "building", 0) + 1
    try:
        yield
    finally:
        _MODE.building -= 1


def program_context() -> bool:
    """True while a program is built, captured, probed or run on this thread
    (a build's eager warm-up included), while the current CUDA stream
    captures a graph, or under ``torch.compile``: the counterpart of the JAX
    package's ``_tracing_active``. Host bookkeeping that must count once per
    host call (plan lookups, telemetry) stays silent then."""
    if in_program() or getattr(_MODE, "building", 0) > 0 or torch.compiler.is_compiling():
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


# ---------------------------------------------------------------------------
# call skeletons
# ---------------------------------------------------------------------------


class _Dynamic:
    """Positional placeholder for a tensor leaf inside the static skeleton."""

    _instance: Optional["_Dynamic"] = None

    def __new__(cls) -> "_Dynamic":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<dynamic>"


DYNAMIC = _Dynamic()


def split_call(args: Tuple, kwargs: Dict[str, Any]):
    """Partition a call into its tensor leaves and a hashable static skeleton.

    Returns ``(treedef, dyn_ix, statics, dynamic)``: ``dynamic`` lists the
    tensor leaves in flattening order, ``statics`` every leaf with those
    replaced by :data:`DYNAMIC`. Python scalars and flags stay static, so the
    program sees the values the eager call saw (a new value is a new program).
    Raises ``TypeError`` on an unhashable non-tensor leaf.
    """
    leaves, treedef = pytree.tree_flatten((args, dict(kwargs)))
    dyn_ix: List[int] = []
    dynamic: List[torch.Tensor] = []
    statics: List[Any] = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            dyn_ix.append(i)
            dynamic.append(leaf)
            statics.append(DYNAMIC)
        else:
            hash(leaf)
            statics.append(leaf)
    return treedef, tuple(dyn_ix), tuple(statics), dynamic


def rebuild_call(treedef, dyn_ix: Tuple[int, ...], statics: Tuple, dynamic: Sequence):
    """Inverse of :func:`split_call`."""
    leaves = list(statics)
    for pos, i in enumerate(dyn_ix):
        leaves[i] = dynamic[pos]
    return pytree.tree_unflatten(leaves, treedef)


def tensor_signature(tensors: Sequence[torch.Tensor]) -> Tuple:
    return tuple((tuple(t.shape), t.dtype, t.device, t.requires_grad) for t in tensors)


def state_signature(state: Dict[str, Any]) -> Optional[Tuple]:
    """The shapes, dtypes and devices of a state dict, or ``None`` when it
    holds a leaf a program cannot own (a list, a CatBuffer not yet
    materialized)."""
    sig = []
    for name, v in state.items():
        if isinstance(v, torch.Tensor):
            sig.append((name, tuple(v.shape), v.dtype, v.device))
        elif isinstance(v, CatBuffer) and v.buffer is not None:
            sig.append((name, "cat", v.capacity, tuple(v.buffer.shape), v.buffer.dtype, v.buffer.device))
        else:
            return None
    return tuple(sig)


# ---------------------------------------------------------------------------
# the eligibility probe
# ---------------------------------------------------------------------------

#: Bookkeeping attributes the runtime itself mutates around a program, never
#: evidence of an update side effect.
_PROBE_EXEMPT = frozenset(
    {
        "_defaults",
        "_computed",
        "_update_called",
        "_forward_cache",
        "_update_count",
        "_pure_mode",
        "_grad_batch",
        "_donation_ready",
        "_slot_owner",
        "_compiled",
        "_plan_binding",
        "_cache",
        "_update_kwarg_names",
        "_ckpt_suppress",
        "_to_sync",
        "_telemetry",
    }
)

_MISSING = object()


def _snapshot_attr(v: Any) -> Any:
    """One attribute for side-effect detection: containers shallow-copied,
    anything else held by reference (compared by identity)."""
    if isinstance(v, list):
        return list(v)
    if isinstance(v, set):
        return set(v)
    if isinstance(v, dict):
        return dict(v)
    return v


def _attr_changed(now: Any, snap: Any) -> bool:
    if isinstance(snap, list):
        return not (isinstance(now, list) and len(now) == len(snap) and all(a is b for a, b in zip(now, snap)))
    if isinstance(snap, set):
        return not (isinstance(now, set) and now == snap)
    if isinstance(snap, dict):
        return not (isinstance(now, dict) and set(now) == set(snap) and all(now[k] is snap[k] for k in snap))
    return now is not snap


def _fake_state(mode: Any, value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return mode.from_tensor(value)
    if isinstance(value, CatBuffer):
        cb = CatBuffer(value.capacity, None if value.buffer is None else mode.from_tensor(value.buffer), value.count, value.overflowed)
        if value.buffer is not None:
            cb._offset = mode.from_tensor(value.device_offset())
        return cb
    if isinstance(value, dict):
        return {k: _fake_state(mode, v) for k, v in value.items()}
    if isinstance(value, list):
        return [_fake_state(mode, v) for v in value]
    return value


def _host_read_guard():
    """A dispatch mode that refuses every host read of a tensor's value
    (``.item()``, ``int()``/``float()``/``bool()`` of a tensor), even of one
    FakeTensorMode can fold to a constant: a CUDA graph capture cannot hold
    one, whatever the value's origin."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _HostReadGuard(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                raise RuntimeError("a host read of a tensor value (aten._local_scalar_dense)")
            return func(*args, **(kwargs or {}))

    return _HostReadGuard()


def probe_traceable(fn: Callable, state: Any, dynamic: Sequence[torch.Tensor], owners: Sequence[Any]) -> Optional[str]:
    """Dry-run ``fn(state, dynamic)`` on fake tensors, in program mode.

    A host read of a tensor's value (``.item()``, ``bool()`` of a tensor, also
    of a value FakeTensorMode could fold to a constant) or a data-dependent
    output shape (``nonzero``, boolean masks), or any other failure, makes the
    program untraceable; so does a change to an owner's instance attributes
    (by identity, containers by shallow contents), a side effect the replay
    would skip. Returns ``None`` when clean, else the reason; whatever the
    probe touched is restored either way.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    snaps = [{k: _snapshot_attr(v) for k, v in m.__dict__.items() if k not in _PROBE_EXEMPT} for m in owners]

    def _restore() -> None:
        for m, snap in zip(owners, snaps):
            for k in list(m.__dict__):
                if k not in _PROBE_EXEMPT and k not in snap:
                    object.__delattr__(m, k)
            for k, v in snap.items():
                if _attr_changed(m.__dict__.get(k, _MISSING), v):
                    object.__setattr__(m, k, v)

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    try:
        fstate = _fake_state(mode, state)
        fdyn = [mode.from_tensor(t) for t in dynamic]
        with mode, _host_read_guard(), program_mode():
            fn(fstate, fdyn)
    except Exception as err:  # noqa: BLE001 - any failure routes to eager
        _restore()
        return f"update is not traceable ({type(err).__name__}: {str(err)[:160]})"
    changed: List[str] = []
    for m, snap in zip(owners, snaps):
        for k in set(m.__dict__) | set(snap):
            if k in _PROBE_EXEMPT:
                continue
            if _attr_changed(m.__dict__.get(k, _MISSING), snap.get(k, _MISSING)):
                changed.append(f"{type(m).__name__}.{k}")
    if changed:
        _restore()
        return (
            "update mutates instance attribute(s) "
            + ", ".join(sorted(changed))
            + " — a side-effect latch the compiled replay would skip"
        )
    return None


def consult_static(pairs) -> Tuple[str, Optional[str]]:
    """metricslint pre-classification for an eligibility probe: aggregate
    ``(metric, kinds)`` pairs into ``("clean"|"dirty"|"unknown", detail)``.

    ``clean`` means every instance's class was statically verified (writes
    only declared states, no host-sync antipatterns, fully resolved scan):
    :func:`probe_traceable` is redundant and is skipped. A host read the
    analysis cannot see is then found by the CUDA graph capture, which
    raises before anything ran: :class:`CaptureError` marks the fallback and
    the states stay intact. ``dirty`` means the static report *refuted*
    eligibility — ``detail`` names the offending attribute and source line.
    ``unknown`` (unresolvable source, dynamic writes,
    ``METRICS_TPU_ANALYSIS_PRECLASSIFY=0``) keeps the probe as the last word.
    Pre-classification only decides whether the probe runs: what a program
    computes, and which kernel it launches, never depends on it.
    """
    from metrics_tpu_torch.analysis.runtime import static_probe_verdict_many

    return static_probe_verdict_many(pairs)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class CaptureError(RuntimeError):
    """A CUDA graph capture failed; nothing ran, so the state is intact and
    the caller falls back to eager for good."""


class _EagerStep:
    """The program cache's entry for a call whose update changes a state's
    shape or dtype (a default that takes the batch's width): it runs eagerly,
    and the next call, on the new signature, compiles."""


EAGER_STEP = _EagerStep()


def _launch_counters() -> List[Tuple[Any, str]]:
    """The launch counters of the port's hand-written kernels: a capture
    records a kernel's launch once, and each replay launches it again."""
    from metrics_tpu_torch.ops import binned_stats, confusion_counts

    return [(binned_stats, "KERNEL_LAUNCHES"), (confusion_counts, "KERNEL_LAUNCHES")]


def _clone_leaf(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, CatBuffer):
        return CatBuffer(v.capacity, None if v.buffer is None else v.buffer.clone(), v.count, v.overflowed)
    if isinstance(v, dict):
        return {k: _clone_leaf(x) for k, x in v.items()}
    return v


def _catbuffers(slots: Any) -> List[CatBuffer]:
    if isinstance(slots, CatBuffer):
        return [slots]
    if isinstance(slots, dict):
        return [cb for v in slots.values() for cb in _catbuffers(v)]
    return []


def _fits(slot: Dict[str, Any], new: Dict[str, Any]) -> bool:
    """Can ``new`` (a program's new state, from its warm-up on a copy of
    ``slot``) be written back into ``slot`` in place: every tensor of the
    same shape and dtype, every CatBuffer appended in place?"""
    for name, target in slot.items():
        value = new[name]
        if isinstance(target, CatBuffer):
            if not isinstance(value, CatBuffer) or value.buffer is None or value.buffer.shape != target.buffer.shape:
                return False
        elif not isinstance(value, torch.Tensor) or value.shape != target.shape or value.dtype != target.dtype:
            return False
    return True


def _write_back(slot: Dict[str, Any], new: Dict[str, Any]) -> None:
    """Copy a program's new state into the slot it read, in place (its
    CatBuffers were appended in place)."""
    for name, target in slot.items():
        if not isinstance(target, CatBuffer) and new[name] is not target:
            target.copy_(new[name])


class Program:
    """One compiled program: ``fn(slots, dynamic) -> (new_states, out)`` run
    in program mode, its new states written back into ``slots``.

    On a CUDA device it is captured into a CUDA graph over static input
    buffers at construction; :meth:`run` copies the inputs in and replays.
    On the CPU :meth:`run` calls the function. ``out`` (a forward's batch
    values) is returned as fresh tensors either way. Build it with
    :meth:`build`, which returns :data:`EAGER_STEP` for a call whose new
    state cannot be written back in place.
    """

    __slots__ = ("fn", "slots", "graph", "static_inputs", "outputs", "row_deltas", "launch_deltas", "pairs")

    def __init__(
        self,
        fn: Callable,
        slots: Dict[Any, Dict[str, Any]],
        pairs: Sequence[Tuple[Dict[str, Any], Any]],
        dynamic: Sequence[torch.Tensor],
        device: torch.device,
        pool: Any = None,
    ) -> None:
        self.fn = fn
        self.slots = slots
        # (slot, key of fn's new-state output) for every slot the program writes
        self.pairs = list(pairs)
        self.graph = None
        self.static_inputs: List[torch.Tensor] = []
        self.outputs: Any = None
        self.row_deltas: List[Tuple[CatBuffer, int]] = []
        self.launch_deltas: List[Tuple[Any, str, int]] = []
        if device.type == "cuda":
            self._capture(dynamic, device, pool)

    @classmethod
    def build(cls, fn: Callable, slots: Dict[Any, Dict[str, Any]], pairs: Sequence[Tuple[Dict[str, Any], Any]],
              dynamic: Sequence[torch.Tensor], device: torch.device, pool: Any = None) -> Any:
        """The program, after an eager warm-up: the update as eager runs it
        (value checks on) on a copy of the state, so that bad input raises
        before anything is captured or written, the card's libraries
        initialise outside the capture, and a new state that would not fit
        its slot makes this call an :data:`EAGER_STEP`."""
        with torch.no_grad(), _building():
            new_states, _ = fn(_clone_leaf(slots), list(dynamic))
        if not all(_fits(slot, new_states if key is None else new_states[key]) for slot, key in pairs):
            return EAGER_STEP
        return cls(fn, slots, pairs, dynamic, device, pool)

    def _step(self, dynamic: Sequence[torch.Tensor]) -> Any:
        # as the eager update: the running states never keep a graph (a
        # forward with grad never comes here)
        with program_mode(), torch.no_grad():
            new_states, out = self.fn(self.slots, dynamic)
            for slot, key in self.pairs:
                _write_back(slot, new_states if key is None else new_states[key])
        return out

    def _capture(self, dynamic: Sequence[torch.Tensor], device: torch.device, pool: Any) -> None:
        self.static_inputs = [t.detach().clone() for t in dynamic]
        cbs = _catbuffers(self.slots)
        counts = [cb.count for cb in cbs]
        counters = _launch_counters()
        launched = [getattr(mod, attr) for mod, attr in counters]
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(device)
        try:
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                self.outputs = self._step(self.static_inputs)
        except Exception as err:  # noqa: BLE001 - any capture failure falls back
            raise CaptureError(f"{type(err).__name__}: {str(err)[:160]}") from err
        finally:
            # a capture executes nothing: the host counts it advanced are
            # advanced again by every replay, below
            self.row_deltas = [(cb, cb.count - c) for cb, c in zip(cbs, counts) if cb.count != c]
            for cb, c in zip(cbs, counts):
                cb.count = c
            self.launch_deltas = [
                (mod, attr, getattr(mod, attr) - n) for (mod, attr), n in zip(counters, launched) if getattr(mod, attr) != n
            ]
            for mod, attr, d in self.launch_deltas:
                setattr(mod, attr, getattr(mod, attr) - d)
        self.graph = graph

    def check_rows(self) -> None:
        """An append a replay would make past a CatBuffer's capacity raises
        here, before the replay writes anything (the host knows both counts)."""
        for cb, n in self.row_deltas:
            if cb.count + n > cb.capacity:
                from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

                raise MetricsTPUUserError(
                    f"CatBuffer overflow: {cb.count} + {n} > capacity {cb.capacity}. "
                    "Construct the metric with a larger `with_capacity(...)`."
                )

    def run(self, dynamic: Sequence[torch.Tensor]) -> Any:
        if self.graph is None:
            return self._step(dynamic)
        self.check_rows()
        for static, t in zip(self.static_inputs, dynamic):
            static.copy_(t)
        self.graph.replay()
        for cb, n in self.row_deltas:
            cb.count += n
        for mod, attr, d in self.launch_deltas:
            setattr(mod, attr, getattr(mod, attr) + d)
        # a replay's outputs live in the graph's pool and are overwritten by
        # the next replay: the caller gets a copy
        return pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, self.outputs)


def dispatch_program(disp: "CompiledDispatcher", kind: str, prog: Program, dynamic: Sequence[torch.Tensor]) -> Any:
    """Run one program and count it, journaling on the host side of the
    replay (``journal.record`` refuses to run inside a capture). Returns the
    program's batch values. A CatBuffer overflow raises before the replay."""
    active = journal.ACTIVE
    if active:
        t0 = time.monotonic()
    out = prog.run(dynamic)
    disp.note_dispatch()
    if active:
        journal.record("compiled.dispatch", label=disp.label, step=disp.steps_seen, op=kind, dur_s=time.monotonic() - t0)
    return out


class CompiledDispatcher:
    """Per-instance compiled-dispatch state: programs, slots, counters.

    One hangs off each ``Metric`` (and ``MetricCollection``) that ever
    considers the compiled path. It owns

    - the programs, keyed by ``(kind, call skeleton, signatures)``, stored in
      the owner's :class:`~metrics_tpu_torch.core.plan.PlanBinding`;
    - the *slots*: for each state signature, the static state buffers the
      programs read and write (a metric's state tensors are these buffers
      while the donation latch is set);
    - one CUDA graph memory pool for all its programs;
    - the counters ``traces`` / ``dispatches`` / ``steps_seen`` of
      ``compile_stats()`` (``cache_hits = dispatches - traces``), kept in the
      registry's ``compile`` domain;
    - the permanent per-kind ``fallback`` map with its one-time diagnostic,
      and the shape-churn warning and storm cap.

    Copies and pickles get a fresh, empty dispatcher.
    """

    __slots__ = ("label", "uid", "_stats", "_binding", "_churn_warned", "slots", "_pool")

    _uid_counter = itertools.count()

    def __init__(self, label: str, stats: Optional[Dict[str, Any]] = None, binding: Optional[Any] = None) -> None:
        self.label = label
        self.uid = next(CompiledDispatcher._uid_counter)
        self._churn_warned = False
        self._stats = stats if stats is not None else {}
        self._stats.setdefault("traces", 0)
        self._stats.setdefault("dispatches", 0)
        self._stats.setdefault("steps_seen", 0)
        if not isinstance(self._stats.get("fallback"), dict):
            self._stats["fallback"] = {}
        if binding is None:
            from metrics_tpu_torch.core.plan import PlanBinding

            binding = PlanBinding(label)
        self._binding = binding
        self.slots: Dict[Tuple, Dict[str, Any]] = {}
        self._pool: Any = None

    @property
    def traces(self) -> int:
        return self._stats["traces"]

    @traces.setter
    def traces(self, v: int) -> None:
        self._stats["traces"] = v

    @property
    def dispatches(self) -> int:
        return self._stats["dispatches"]

    @dispatches.setter
    def dispatches(self, v: int) -> None:
        self._stats["dispatches"] = v

    @property
    def steps_seen(self) -> int:
        return self._stats["steps_seen"]

    @steps_seen.setter
    def steps_seen(self, v: int) -> None:
        self._stats["steps_seen"] = v

    @property
    def fallback(self) -> Dict[str, str]:
        return self._stats["fallback"]

    def mark_fallback(self, kind: str, reason: str, warn: bool = True) -> None:
        """Permanently route ``kind`` dispatches to eager for this instance."""
        if kind in self.fallback:
            return
        self.fallback[kind] = reason
        if journal.ACTIVE:
            journal.record("compiled.fallback", label=self.label, step=self.steps_seen, op=kind, reason=reason)
        if warn:
            diagnostics.warn_once(
                ("compiled-fallback", self.uid),
                f"{self.label}: compiled eager {kind} disabled for this instance — "
                f"{reason}. The per-op eager path (bit-identical, slower) is used "
                f"instead; escape hatches: {COMPILED_UPDATE_ENV}=0 process-wide or "
                "`metric.compiled_update = False`.",
                UserWarning,
            )

    def probed(self, key: Any) -> bool:
        return key in self._binding.probed

    def mark_probed(self, key: Any) -> None:
        self._binding.probed.add(key)

    def slot(self, sig: Tuple, state: Dict[str, Any]) -> Dict[str, Any]:
        """The static state buffers of signature ``sig`` (made from ``state``
        at first use). A CatBuffer slot carries its device-side fill offset."""
        slot = self.slots.get(sig)
        if slot is None:
            slot = {}
            for name, v in state.items():
                if isinstance(v, CatBuffer):
                    cb = CatBuffer(v.capacity, v.buffer.clone(), v.count, v.overflowed)
                    cb._offset = torch.full((), v.count, dtype=torch.int64, device=v.buffer.device)
                    slot[name] = cb
                else:
                    slot[name] = v.detach().clone()
            self.slots[sig] = slot
        return slot

    def program(self, key: Any, build: Callable[[], Any]) -> Optional[Program]:
        """The program for ``key``, built (warmed up and captured) at first
        use; a build counts as one trace. ``None`` for a key whose calls run
        eagerly (:data:`EAGER_STEP`)."""
        prog = self._binding.programs.get(key)
        if prog is None:
            prog = build()
            self._binding.programs[key] = prog
            if prog is EAGER_STEP:
                return None
            self.traces += 1
            if journal.ACTIVE:
                journal.record("compiled.trace", label=self.label, step=self.steps_seen, op=key[0], traces=self.traces)
        return None if prog is EAGER_STEP else prog

    def pool(self, device: torch.device) -> Any:
        """One CUDA graph memory pool shared by all of this owner's programs
        (they replay one at a time, on one stream)."""
        if device.type != "cuda":
            return None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def note_dispatch(self) -> None:
        self.dispatches += 1
        if not self._churn_warned and self.traces >= trace_warn_threshold():
            self._churn_warned = True
            diagnostics.warn_once(
                ("compiled-trace-churn", self.uid),
                f"{self.label}: the compiled eager path retraced {self.traces} times — "
                "churn in the call signature (ragged last batches, a state whose shape "
                "grows every step, or a python-scalar argument whose value changes per "
                "batch). Each new signature is captured once and then replays, so a "
                "few ragged epoch tails are cheap after the first epoch; unbounded "
                "variety is not. Pad batches to a fixed size (or a small set of bucket "
                "sizes) and pass per-batch scalars as tensors, or set "
                "`compiled_update=False` on this metric. At "
                f"{trace_storm_threshold()} traces this instance falls back to eager "
                "permanently.",
                UserWarning,
            )

    def storming(self, kind: str) -> bool:
        """True once captures crossed the storm threshold: marks ``kind``
        permanently eager."""
        if self.traces < trace_storm_threshold():
            return False
        self.mark_fallback(
            kind,
            f"recompile storm: {self.traces} traces — the call signature (shapes or "
            "static python-scalar values) changes too often for a cached program to "
            "pay off",
        )
        return True

    def __deepcopy__(self, memo: dict) -> "CompiledDispatcher":
        return CompiledDispatcher(self.label)

    def __reduce__(self):
        return (CompiledDispatcher, (self.label,))
