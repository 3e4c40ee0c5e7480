"""Structured event journal: the runtime's facts, in time order, per rank.

Counterpart of ``metrics_tpu/observability/journal.py``, with the same
event catalog, the same :class:`Event` and the same reading and subscribing
API, so one consumer reads the journals of both packages.

- **Off by default, free when off.** :data:`ACTIVE` is a module attribute;
  every emission site guards with ``if journal.ACTIVE:`` before it builds
  any argument, so with the recorder off a site costs one attribute read
  and allocates nothing.
- **No host read, no lock on the hot path.** An event is stamped with the
  host's monotonic clock (``time.monotonic()``), never with a device value,
  and each thread writes its own pre-allocated ring (``capacity`` events,
  the oldest overwritten); the one lock is taken when a thread registers
  its ring.
- **Never while a CUDA graph is captured.** :func:`record` raises inside a
  capture: the event would fire once per capture instead of once per
  replayed step.
- **The same sequence on every rank.** Sync-path emission sites take no
  rank-dependent branch, so two ranks in lockstep record equal
  ``(kind, label)`` sequences (checkpoint events are per-rank facts by
  design: each rank writes its own shard).

The rank of an event is ``torch.distributed.get_rank()`` when a process
group is initialised, else 0; :func:`set_rank_provider` installs another
(a world of ranks on threads installs its thread-local rank).
"""
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

__all__ = [
    "EVENT_KINDS",
    "ACTIVE",
    "Event",
    "Subscription",
    "clear",
    "disable",
    "enable",
    "enabled",
    "event_sequence",
    "events",
    "on_event",
    "record",
    "set_rank_provider",
]

#: Event-kind catalog: ``<class>.<what>``, the JAX package's. The class
#: (before the dot) is the unit of :func:`on_event`'s filter.
EVENT_KINDS: Dict[str, str] = {
    # ---- compiled hot path -----------------------------------------------
    "compiled.trace": "an XLA (re)trace of a compiled update/forward program",
    "compiled.dispatch": "one compiled donated-state dispatch (the step span)",
    "compiled.fallback": "an instance permanently routed to eager, with reason",
    # ---- host sync (parallel/sync.py, parallel/bucketing.py) -------------
    "sync.gather": "a blocking health-checked host sync issuing collectives",
    "sync.plan": "a bucketed sync plan built (plan-cache miss)",
    "sync.launch": "a non-blocking round launched onto the background lane",
    "sync.resolve": "an overlapped round consumed, with staleness verdict",
    "sync.drain": "a round drained and discarded (the symmetric cancel)",
    "sync.hop": "one hop of the tiered schedule (intra gather / inter exchange / broadcast)",
    # ---- health / fault tolerance (parallel/health.py) -------------------
    "health.failure": "a typed SyncError observed at a sync boundary",
    "health.watchdog": "a sync watchdog fired on a stuck collective",
    "health.margin": "a guarded collective finished, with watchdog headroom",
    "health.channel_suspect": "the channel entered probation (suspect)",
    "health.channel_probe": "probation cooldown elapsed; one probe round allowed",
    "health.channel_readmit": "a probe round succeeded; channel readmitted",
    "health.channel_reset": "the channel forced healthy (manual reset)",
    # ---- elastic resilience ----------------------------------------------
    "resilience.membership": "a negotiated membership transition (shrink/readmit)",
    "resilience.quorum": "a quorum-degraded sync negotiated over survivors",
    # ---- adaptive controller ---------------------------------------------
    "controller.timeout": "the controller committed a new watchdog timeout",
    "controller.schedule": "a schedule-affecting controller decision committed",
    "controller.revert": "controller decisions reverted to defaults",
    # ---- degradation (Metric._handle_sync_failure) -----------------------
    "degrade.local": "a sync failure swallowed under on_error='local'/'warn'",
    # ---- checkpointing (core/checkpoint.py) ------------------------------
    "checkpoint.save": "one rank shard atomically written",
    "checkpoint.load": "a snapshot restored (elastic folds included)",
    "checkpoint.prune": "retention removed old snapshot steps",
    "checkpoint.refused": "a snapshot refused (in-flight round / synced state)",
    # ---- compute groups (core/collections.py) ----------------------------
    "group.form": "a compute group formed (members share one state + update)",
    "group.detach": "a member copy-on-write detached from its group",
    # ---- unified execution plan ------------------------------------------
    "plan.build": "an ExecutionPlan built for a new state schema (cache miss)",
    "plan.hit": "an ExecutionPlan served from the unified plan cache",
    "plan.invalidate": "a state mutation invalidated an owner's plan binding",
    "plan.fused_step": "a whole-step fused program engaged (update+sync+compute)",
    "plan.tier": "a tiered (two-level) schedule derived for a schema + topology",
}

#: Fast emission gate: True while the ring recorder is on or any subscriber
#: is registered. Hot call sites read it before building event arguments.
ACTIVE: bool = False

_DEFAULT_CAPACITY = 65536

_enabled = False
_capacity = _DEFAULT_CAPACITY
_subscribers: List["Subscription"] = []

_registry_lock = threading.Lock()
_buffers: List["_ThreadBuffer"] = []
_generation = 0
_tls = threading.local()


class Event:
    """One journal entry: monotonic time, rank, step, kind, label, fields."""

    __slots__ = ("ts", "rank", "step", "kind", "label", "fields")

    def __init__(self, ts: float, rank: int, step: int, kind: str, label: str, fields: Dict[str, Any]) -> None:
        self.ts = ts
        self.rank = rank
        self.step = step
        self.kind = kind
        self.label = label
        self.fields = fields

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Event({self.kind!r}, label={self.label!r}, rank={self.rank}, "
            f"step={self.step}, ts={self.ts:.6f}, {self.fields})"
        )

    def as_dict(self) -> Dict[str, Any]:
        return {"ts": self.ts, "rank": self.rank, "step": self.step, "kind": self.kind, "label": self.label,
                **self.fields}


class _ThreadBuffer:
    """One thread's pre-allocated event ring. Its thread is the only writer
    (``slots[n % capacity] = ev; n += 1``); readers snapshot after the
    workload is quiet."""

    __slots__ = ("name", "slots", "n", "gen")

    def __init__(self, name: str, capacity: int, gen: int) -> None:
        self.name = name
        self.slots: List[Optional[Event]] = [None] * capacity
        self.n = 0
        self.gen = gen

    def snapshot(self) -> List[Event]:
        n, cap = self.n, len(self.slots)
        if n <= cap:
            return [e for e in self.slots[:n] if e is not None]
        start = n % cap
        return [e for e in self.slots[start:] + self.slots[:start] if e is not None]


def _default_rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


_rank_provider: Callable[[], int] = _default_rank


def set_rank_provider(fn: Optional[Callable[[], int]]) -> Callable[[], int]:
    """Install a rank provider (``None`` restores the default); returns the
    previous one, so that a harness can restore it."""
    global _rank_provider
    prev = _rank_provider
    _rank_provider = _default_rank if fn is None else fn
    return prev


def _refresh_active() -> None:
    global ACTIVE
    ACTIVE = _enabled or bool(_subscribers)


def enable(capacity: Optional[int] = None) -> None:
    """Turn the ring recorder on (idempotent). ``capacity`` sets the ring
    size of each thread (default 65536 events); a new size clears the
    recorded events."""
    global _enabled, _capacity
    if capacity is not None and capacity != _capacity:
        _capacity = int(capacity)
        clear()
    _enabled = True
    _refresh_active()


def disable() -> None:
    """Turn the recorder off. Recorded events stay readable until
    :func:`clear`; subscribers go on receiving events."""
    global _enabled
    _enabled = False
    _refresh_active()


def enabled() -> bool:
    return _enabled


def clear() -> None:
    """Drop every recorded event (the rings of all threads)."""
    global _generation
    with _registry_lock:
        _buffers.clear()
        # other threads' rings re-register at their next record(): their
        # generation no longer matches
        _generation += 1


def _thread_buffer() -> _ThreadBuffer:
    buf = getattr(_tls, "buffer", None)
    if buf is None or buf.gen != _generation:
        buf = _ThreadBuffer(threading.current_thread().name, _capacity, _generation)
        with _registry_lock:
            _buffers.append(buf)
        _tls.buffer = buf
    return buf


class Subscription:
    """Handle of one :func:`on_event` subscriber; ``close()`` detaches it."""

    __slots__ = ("callback", "classes", "_closed")

    def __init__(self, callback: Callable[[Event], Any], classes: Optional[frozenset]) -> None:
        self.callback = callback
        self.classes = classes
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            _subscribers.remove(self)
        except ValueError:
            pass
        _refresh_active()

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def on_event(callback: Callable[[Event], Any], classes: Optional[Iterable[str]] = None) -> Subscription:
    """Call ``callback(event)`` at every emission, on the emitting thread.

    ``classes`` keeps the event classes named (``("health", "degrade")``
    wires the fault stream into a fleet logger); ``None`` keeps all. A
    subscriber turns emission on even while the ring recorder is off. The
    callback must be cheap; its exceptions are swallowed, so that telemetry
    never takes a step down. Returns a :class:`Subscription`, also a
    context manager."""
    sub = Subscription(callback, None if classes is None else frozenset(classes))
    _subscribers.append(sub)
    _refresh_active()
    return sub


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def record(kind: str, label: str = "", step: int = -1, **fields: Any) -> None:
    """Emit one event; a no-op while :data:`ACTIVE` is off (hot sites guard
    on the flag themselves, so that they build no arguments either).

    Raises ``RuntimeError`` inside a CUDA graph capture: an event recorded
    there would fire once per capture, not once per replayed step."""
    if not ACTIVE:
        return
    if _capturing():
        raise RuntimeError(
            f"observability.journal.record({kind!r}) called while a CUDA graph is "
            "being captured: events are recorded on the host side of a launch, "
            "never inside a capture (the event would fire once per capture, not "
            "once per replayed step)."
        )
    ev = Event(time.monotonic(), _rank_provider(), step, kind, label, fields)
    if _enabled:
        buf = _thread_buffer()
        buf.slots[buf.n % len(buf.slots)] = ev
        buf.n += 1
    if _subscribers:
        cls = kind.partition(".")[0]
        for sub in list(_subscribers):
            if sub.classes is None or cls in sub.classes:
                try:
                    sub.callback(ev)
                except Exception:  # noqa: BLE001 - telemetry never raises into the step
                    pass


def events(kinds: Optional[Iterable[str]] = None, rank: Optional[int] = None) -> List[Event]:
    """Every recorded event, merged across threads, sorted by time.

    ``kinds`` keeps exact kinds or classes (``"sync"`` keeps every
    ``sync.*``); ``rank`` keeps one rank's. Read once the workload is
    quiet (rings are single-writer)."""
    with _registry_lock:
        bufs = list(_buffers)
    out: List[Event] = []
    for buf in bufs:
        out.extend(buf.snapshot())
    if kinds is not None:
        wanted = set(kinds)
        out = [e for e in out if e.kind in wanted or e.kind.partition(".")[0] in wanted]
    if rank is not None:
        out = [e for e in out if e.rank == rank]
    out.sort(key=lambda e: e.ts)
    return out


def event_sequence(rank: Optional[int] = None) -> List[Tuple[str, str]]:
    """The ``(kind, label)`` sequence of the recorded events in time order,
    the form in which the cross-rank symmetry checks compare journals."""
    return [(e.kind, e.label) for e in events(rank=rank)]
