"""Non-blocking, double-buffered host sync: the collective rides behind the step.

Counterpart of ``metrics_tpu/parallel/async_sync.py``. ``sync()`` and
``compute()`` stall every rank for the health-word gather and the bucketed
payload; ``sync(blocking=False)`` and ``sync_mode="overlap"`` (the wiring is
in ``core/metric.py`` and ``core/collections.py``) launch it early and
consume it later:

- **Double buffering.** A launch moves the live accumulation into an
  :class:`AsyncSyncRound` snapshot and restarts the live state on fresh
  defaults; the training loop keeps updating those (the post-snapshot
  delta) while the snapshot rides the background collectives. Nothing is
  shared between the two sides, and the launch clears the compiled path's
  donation latch, so no replay writes into the snapshot.
- **One background lane, in launch order.** Every round runs the full
  health-checked ``host_sync_state`` (watchdog included) on one dedicated
  daemon thread (:class:`SerialExecutor`). Every foreground host sync first
  drains the rounds this process launched (:func:`sync_channel`): launch
  points are program order, the same on every rank, so the collective order
  is the same on every rank.
- **Epochs.** A round's ``sync_epoch`` (``core/plan.py::next_sync_epoch``)
  rides the health word, which every rank verifies equal: a rank resolving
  round N never pairs with a peer's blocking sync (epoch 0) or another round;
  the mispairing raises ``StateDivergenceError`` on every rank.
- **Staleness is reported, never mixed** (:data:`STALENESS_POLICIES`):
  ``"snapshot"`` serves the world state at the snapshot cut, ``"merge"``
  folds this rank's post-snapshot delta in, ``"fresh"`` raises
  :class:`~metrics_tpu_torch.utils.exceptions.StaleSyncError`.
- **Failure degrades as blocking does**: the round's typed error surfaces at
  resolve, after the full local accumulation (snapshot plus delta) is
  restored.
- **Cancel means drain** (:func:`drain_round`): a round's collectives were
  launched at the same program point on every rank, so every rank waits it
  out and discards its result; ``future.cancel()`` is never used.

**On the card.** A round's snapshot is produced on the caller's CUDA stream:
the launch records an event there, and the lane waits on it from a side
stream of its own before any collective reads the snapshot (whose tensors
``record_stream`` that side stream). The resolve makes the caller's stream
wait on the lane's finishing event. Under NCCL the lane's collectives are
kernels on the side stream; under gloo, host copies.

The plans of ``core/plan.py`` are lock-protected and keyed on the schema,
so repeated rounds hit one plan from the background lane.
"""
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeoutError
from concurrent.futures import wait as _futures_wait
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, SyncTimeoutError

__all__ = [
    "STALENESS_POLICIES",
    "AsyncSyncRound",
    "SerialExecutor",
    "drain_round",
    "launch_round",
    "new_sync_stats",
    "resolve_round",
    "sync_channel",
    "validate_staleness_policy",
]

#: Accepted ``staleness_policy`` values (see the module docstring).
STALENESS_POLICIES = ("fresh", "snapshot", "merge")


def validate_staleness_policy(policy: str) -> str:
    if policy not in STALENESS_POLICIES:
        raise MetricsTPUUserError(f"`staleness_policy` must be one of {STALENESS_POLICIES}, got {policy!r}")
    return policy


def new_sync_stats() -> Dict[str, Any]:
    """A fresh ``sync_stats()`` counter block, the registry's ``sync``
    domain defaults: rounds ``launched``/``resolved``/``cancelled``,
    ``stale_resolves``, ``degraded``, ``served_local`` (overlap-mode reads
    served from local state before any round resolved), ``gather_s`` (the
    background collectives' wall clock), ``resolve_wait_s`` (how long
    resolves blocked) and ``overlap_saved_s`` (their difference, per round:
    the collective time hidden behind the step)."""
    from metrics_tpu_torch.observability.registry import DOMAIN_DEFAULTS

    return {k: (dict(v) if isinstance(v, dict) else v) for k, v in DOMAIN_DEFAULTS["sync"].items()}


# ---------------------------------------------------------------------------
# the background lane
# ---------------------------------------------------------------------------


class SerialExecutor:
    """One daemon worker running submitted tasks strictly in order.

    Not ``concurrent.futures.ThreadPoolExecutor``: its workers are joined at
    interpreter exit, so a round stuck on a dead peer would hang shutdown,
    the very stall the watchdog exists to prevent. ``initializer`` runs once
    on the worker before any task (a world of thread ranks uses it to adopt
    a rank's identity).
    """

    def __init__(self, name: str, initializer: Optional[Callable[[], None]] = None) -> None:
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._initializer = initializer
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        if self._initializer is not None:
            self._initializer()
        while True:
            item = self._queue.get()
            if item is None:
                return
            fn, future = item
            if not future.set_running_or_notify_cancel():
                continue
            try:
                future.set_result(fn())
            except BaseException as err:  # noqa: BLE001 - delivered through the future
                future.set_exception(err)

    def submit(self, fn: Callable[[], Any]) -> Future:
        future: Future = Future()
        self._queue.put((fn, future))
        return future

    def shutdown(self, wait: bool = False) -> None:
        self._queue.put(None)
        if wait:
            self._thread.join()


_EXECUTOR: Optional[SerialExecutor] = None
_EXECUTOR_LOCK = threading.Lock()

_PENDING_LOCK = threading.Lock()
_PENDING: Dict[Any, Any] = {}  # future -> (launch domain, sync_epoch, metric_name)

#: Set while the lane runs a round's task: :func:`sync_channel` then skips
#: the drain (a round waiting on itself would deadlock).
_IN_ROUND = threading.local()

#: The lane's side stream per device (one lane thread per process).
_SIDE = threading.local()


def _current_domain() -> Any:
    """The launching rank's identity: one per process in a real world, so a
    constant. A world of thread ranks patches it to the thread's rank, so a
    rank drains only the rounds it launched, as a process would."""
    return None


def _get_executor() -> SerialExecutor:
    """The one background lane of this process (a world of thread ranks
    patches it to give each rank a lane of its own). One worker is a
    correctness property: rounds run in launch order."""
    global _EXECUTOR
    with _EXECUTOR_LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = SerialExecutor("metrics-tpu-async-sync")
        return _EXECUTOR


def _drain_pending(timeout: Optional[float] = None) -> None:
    """Wait until every round this process launched finished its collectives
    (their results stay in the futures for their resolvers), within the
    watchdog's bound: past it the channel is marked suspect and a
    :class:`SyncTimeoutError` raises, as a stuck blocking gather would."""
    domain = _current_domain()
    with _PENDING_LOCK:
        pending = {f: meta for f, meta in _PENDING.items() if meta[0] == domain}
    if not pending:
        return
    from metrics_tpu_torch.parallel.health import get_sync_timeout, mark_channel_suspect

    limit = get_sync_timeout(timeout)
    start = time.monotonic()
    _done, not_done = _futures_wait(list(pending), timeout=limit if limit > 0 else None)
    if not_done:
        mark_channel_suspect()
        stuck = sorted(f"sync_epoch {pending[f][1]} of {pending[f][2]}" for f in not_done)
        raise SyncTimeoutError(
            f"{len(not_done)} in-flight overlapped sync round(s) ({'; '.join(stuck)}) did not complete "
            f"within {limit:g}s (waited {time.monotonic() - start:.1f}s): a peer process is likely dead or "
            "stalled mid-round. Raise METRICS_TPU_SYNC_TIMEOUT_S for slow interconnects, or recover with "
            "on_error='local'."
        )


@contextmanager
def sync_channel() -> Iterator[None]:
    """Order one host sync after the rounds this process launched: a
    foreground caller drains them first, so its gathers pair with its peers'
    and never with a straggling round. The lane itself skips the drain."""
    if not getattr(_IN_ROUND, "active", False):
        _drain_pending()
    yield


# ---------------------------------------------------------------------------
# CUDA stream ordering
# ---------------------------------------------------------------------------


def _cuda_tensors(tree: Any) -> List[torch.Tensor]:
    from metrics_tpu_torch.core.cat_buffer import CatBuffer

    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_cuda else []
    if isinstance(tree, CatBuffer):
        return _cuda_tensors(tree.buffer)
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _cuda_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _cuda_tensors(v)]
    return []


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    streams = getattr(_SIDE, "streams", None)
    if streams is None:
        streams = _SIDE.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


# ---------------------------------------------------------------------------
# rounds: launch / resolve / drain
# ---------------------------------------------------------------------------


class AsyncSyncRound:
    """One in-flight round: the snapshot it gathers (moved out of the live
    metric), the launch-time ``update_count`` staleness is judged against,
    the ``epoch``, the future of the gathered state or its typed error, the
    background ``gather_s``; on the card the launch's ``ready`` event and
    the lane's ``done`` event."""

    __slots__ = (
        "snapshot",
        "reductions",
        "update_count",
        "epoch",
        "metric_name",
        "future",
        "gather_s",
        "gather_started",
        "launched_monotonic",
        "device",
        "ready",
        "done",
    )

    def __init__(
        self, snapshot: Dict[str, Any], reductions: Dict[str, Any], *, update_count: int, epoch: int, metric_name: str
    ) -> None:
        self.snapshot = snapshot
        self.reductions = reductions
        self.update_count = int(update_count)
        self.epoch = int(epoch)
        self.metric_name = metric_name
        self.future: Any = None
        self.gather_s = 0.0
        self.gather_started = 0.0
        self.launched_monotonic = time.monotonic()
        self.device: Optional[torch.device] = None
        self.ready: Any = None
        self.done: Any = None


def launch_round(
    snapshot: Dict[str, Any],
    reductions: Dict[str, Any],
    *,
    update_count: int,
    epoch: int,
    metric_name: str = "metric",
    group: Optional[Any] = None,
    strict_update_count: bool = False,
    timeout: Optional[float] = None,
    fused: Optional[bool] = None,
    sync_fn: Optional[Callable[[], Dict[str, Any]]] = None,
    on_missing: str = "raise",
    stats: Optional[Dict[str, Any]] = None,
    sync_precision: Optional[str] = None,
) -> AsyncSyncRound:
    """Launch the health-checked host sync of ``snapshot`` on the lane and
    return at once. The round's future holds the synced state, or the same
    typed ``SyncError`` the blocking path would raise: it is the blocking
    code (``host_sync_state`` with this round's ``sync_epoch``, ``group``,
    ``on_missing`` and ``sync_precision``), run on another thread, so a
    quorum round that loses ranks shrinks and retries over the survivors on
    the lane, and a tiered round runs the same (optionally quantized) slow
    hop. ``sync_fn`` replaces the transport (a custom ``dist_sync_fn``)."""
    from metrics_tpu_torch.parallel.quantize import validate_sync_precision
    from metrics_tpu_torch.parallel.sync import check_on_missing

    check_on_missing(on_missing, group)
    sync_precision = validate_sync_precision(sync_precision)
    round_ = AsyncSyncRound(snapshot, reductions, update_count=update_count, epoch=epoch, metric_name=metric_name)
    leaves = _cuda_tensors(snapshot)
    if leaves:
        round_.device = leaves[0].device
        round_.ready = torch.cuda.Event()
        round_.ready.record(torch.cuda.current_stream(round_.device))

    def gather() -> Dict[str, Any]:
        from metrics_tpu_torch.parallel.sync import host_sync_state

        if sync_fn is not None:
            with sync_channel():
                return sync_fn()
        return host_sync_state(
            round_.snapshot,
            round_.reductions,
            group,
            update_count=round_.update_count,
            strict_update_count=strict_update_count,
            timeout=timeout,
            metric_name=round_.metric_name,
            fused=fused,
            on_missing=on_missing,
            sync_epoch=round_.epoch,
            stats=stats,
            sync_precision=sync_precision,
        )

    def task() -> Dict[str, Any]:
        _IN_ROUND.active = True
        start = time.monotonic()
        round_.gather_started = start
        try:
            if round_.ready is None:
                return gather()
            stream = _side_stream(round_.device)
            with torch.cuda.device(round_.device), torch.cuda.stream(stream):
                stream.wait_event(round_.ready)
                for t in leaves:
                    t.record_stream(stream)
                out = gather()
                round_.done = torch.cuda.Event()
                round_.done.record(stream)
            return out
        finally:
            round_.gather_s = time.monotonic() - start
            _IN_ROUND.active = False

    if journal.ACTIVE:
        journal.record("sync.launch", label=metric_name, sync_epoch=epoch, update_count=int(update_count))
    domain = _current_domain()
    future = _get_executor().submit(task)
    round_.future = future
    with _PENDING_LOCK:
        _PENDING[future] = (domain, round_.epoch, metric_name)
    future.add_done_callback(_discard_pending)
    return round_


def _discard_pending(future: Any) -> None:
    with _PENDING_LOCK:
        _PENDING.pop(future, None)


def resolve_round(round_: AsyncSyncRound, timeout: Optional[float] = None):
    """Block until the round's gathered state is there; ``(synced_state,
    wait_s)``, ``wait_s`` how long this call blocked (about 0 when the
    gather finished behind the step). Raises the round's typed error as it
    is; a round that cannot finish within twice the watchdog bound marks
    the channel suspect and raises :class:`SyncTimeoutError`. On the card
    the caller's stream then waits on the lane's work."""
    from metrics_tpu_torch.parallel.health import get_sync_timeout, mark_channel_suspect

    limit = get_sync_timeout(timeout)
    start = time.monotonic()
    try:
        # the watchdog inside host_sync_state fires first on a dead peer;
        # this bound guards the lane itself
        synced = round_.future.result(timeout=2 * limit if limit > 0 else None)
    except _FutureTimeoutError:
        mark_channel_suspect()
        raise SyncTimeoutError(
            f"overlapped sync round of {round_.metric_name} did not resolve within {2 * limit:g}s "
            f"(sync_epoch={round_.epoch}, waited {time.monotonic() - start:.1f}s, watchdog timeout {limit:g}s): "
            "a peer process is likely dead or stalled mid-round. Recover with on_error='local' or restart "
            "the process group."
        ) from None
    if round_.done is not None:
        stream = torch.cuda.current_stream(round_.device)
        stream.wait_event(round_.done)
        for t in _cuda_tensors(synced):
            t.record_stream(stream)
    return synced, time.monotonic() - start


def drain_round(round_: AsyncSyncRound, timeout: Optional[float] = None) -> None:
    """The symmetric cancel: wait the round out and discard its result or
    its error, on every rank alike; the snapshot the caller folds back is
    untouched either way."""
    if journal.ACTIVE:
        journal.record("sync.drain", label=round_.metric_name, sync_epoch=round_.epoch)
    try:
        resolve_round(round_, timeout=timeout)
    except Exception:  # noqa: BLE001 - discarded on every rank alike
        return None
