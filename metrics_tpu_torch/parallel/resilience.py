"""Elastic fleet resilience: quorum membership, probation, adaptive control.

Counterpart of ``metrics_tpu/parallel/resilience.py``. One dead or
preempted rank used to drop every later sync to local-only values: the
watchdog fired, and the channel-suspect latch refused every sync until a
manual ``reset_channel_health()``. Three mechanisms replace that:

- **Quorum membership.** A per-process :class:`Membership` (epoch and sorted
  live-rank tuple) says which ranks of the default ``torch.distributed``
  world take part in host collectives. Under ``on_missing="quorum"`` a sync
  that loses ranks negotiates a smaller membership symmetrically (every
  survivor probes the same fleet, proposes ``local_epoch + 1`` over the same
  survivor set and takes the max) and runs the health-checked gather again
  over the survivors alone. The health word carries the membership epoch and
  live count (``parallel/health.py``), so a rank that missed a transition
  makes every rank raise ``StateDivergenceError``. With every rank live
  none of this runs: the sync is the one without quorum, bit for bit.
- **Probation.** The latch becomes a state machine: ``healthy -> suspect``
  (a watchdog fired) -> a cooldown that doubles, capped, on each failed
  probe -> ``probe`` (one sync goes through) -> readmitted when it succeeds.
  ``parallel/health.py``'s latch functions delegate here.
- **Adaptive control.** :class:`AdaptiveController` subscribes to the
  journal (``observability.on_event``) and sets the watchdog timeout from an
  EWMA of gather times, with a floor. The watchdog bounds how long a rank
  waits, never which collectives run, so a rank-local value is safe.
  Decisions that would change the collective schedule go through
  :func:`commit_schedule_decision`, from symmetric inputs only (the
  membership epoch); each is journaled and revertible.

**Transport.** ``torch.distributed`` cannot shrink a process group in place
under a collective that hangs on a dead peer, so negotiation and the
survivors' gathers ride a transport installed with
:func:`set_quorum_transport`: an object with ``probe()`` (the reachable
ranks, this one included), ``negotiate_allgather(vec, live)`` (a
``[len(live), k]`` integer array) and ``subset_allgather(x, live)`` (the
stacked ``[len(live), ...]`` tensor; ``x`` arrives on the state's device).
The package ships none, as the JAX package ships none: a deployment builds
one (gloo groups made with ``torch.distributed.new_group``, liveness from
the c10d store: ``chip_smoke.py``'s resilience phase), a test world installs
its own. Without one, quorum mode warns once and the error goes to the
``on_error`` ladder unchanged.

Every transition and decision is a journaled event (``resilience.membership``,
``resilience.quorum``, ``health.channel_*``, ``controller.*``).
"""
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.observability.registry import add_process, bump_process, set_process
from metrics_tpu_torch.utils.exceptions import StateDivergenceError, SyncError, SyncTimeoutError

__all__ = [
    "Membership",
    "AdaptiveController",
    "advance_membership",
    "active_subset_transport",
    "adaptive_sync_timeout",
    "channel_gate",
    "channel_is_suspect",
    "channel_probe_succeeded",
    "commit_schedule_decision",
    "configure_probation",
    "current_membership",
    "effective_world",
    "is_missing_rank_error",
    "last_schedule_decisions",
    "live_ranks",
    "mark_channel_suspect",
    "maybe_rejoin",
    "membership_epoch",
    "negotiate_quorum",
    "note_sync_round",
    "reset_channel_health",
    "reset_resilience",
    "set_quorum_transport",
]

#: The clock seam (probation tests freeze it instead of sleeping).
_now = time.monotonic


def _current_domain() -> Any:
    """The owning process's identity: one per process in a real world, so a
    constant. A world of thread ranks patches it to the thread's rank, as
    ``async_sync._current_domain``, so each rank keeps its own membership,
    probation state and flap window."""
    return None


_STATE_LOCK = threading.Lock()


def _to_numpy(x: Any) -> np.ndarray:
    import torch

    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------


class Membership:
    """One negotiated membership: ``epoch`` (monotonic per domain), the
    sorted ``live`` ranks and the ``world`` the fleet started with.
    ``degraded`` is the one bit the sync path branches on."""

    __slots__ = ("epoch", "live", "world")

    def __init__(self, epoch: int, live: Any, world: int) -> None:
        self.epoch = int(epoch)
        self.live: Tuple[int, ...] = tuple(sorted(int(r) for r in live))
        self.world = int(world)

    @property
    def degraded(self) -> bool:
        return len(self.live) < self.world

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Membership(epoch={self.epoch}, live={self.live}, world={self.world})"


_MEMBERSHIPS: Dict[Any, Membership] = {}


def _full_world() -> int:
    """The default world's size (1 with no process group): the seam
    ``parallel/sync.py`` reads it through, which a world of thread ranks
    patches."""
    from metrics_tpu_torch.parallel import sync

    return sync._world_size(None) if sync.distributed_available(None) else 1


def current_membership() -> Membership:
    """This domain's membership (at first the full world's, epoch 0)."""
    key = _current_domain()
    with _STATE_LOCK:
        m = _MEMBERSHIPS.get(key)
        if m is None:
            world = _full_world()
            m = Membership(0, range(world), world)
            _MEMBERSHIPS[key] = m
        return m


def membership_epoch() -> int:
    """The membership epoch (0 until a transition): every live rank agreed
    on it by negotiation."""
    m = _MEMBERSHIPS.get(_current_domain())
    return 0 if m is None else m.epoch


def live_ranks() -> Tuple[int, ...]:
    """The negotiated live ranks (every rank until a transition)."""
    m = _MEMBERSHIPS.get(_current_domain())
    return tuple(range(_full_world())) if m is None else m.live


def live_count() -> int:
    """``len(live_ranks())``."""
    m = _MEMBERSHIPS.get(_current_domain())
    return _full_world() if m is None else len(m.live)


def effective_world() -> int:
    """The ranks a default-world gather spans: the full world, or the
    survivors once a quorum transition shrank the membership."""
    m = _MEMBERSHIPS.get(_current_domain())
    if m is None or not m.degraded:
        return _full_world()
    return len(m.live)


def advance_membership(live: Any, epoch: int, reason: str = "shrink") -> Membership:
    """Install the negotiated ``(epoch, live)`` membership.

    Epoch-guarded and idempotent: a proposal at or below the current epoch
    returns the installed membership. A transition is journaled and resets
    probation to healthy (the channel is negotiated anew over the live set).
    """
    key = _current_domain()
    with _STATE_LOCK:
        cur = _MEMBERSHIPS.get(key)
        world = cur.world if cur is not None else _full_world()
        cur_epoch = cur.epoch if cur is not None else 0
        if int(epoch) <= cur_epoch:
            return cur if cur is not None else Membership(0, range(world), world)
        prev_live = cur.live if cur is not None else tuple(range(world))
        m = Membership(epoch, live, world)
        _MEMBERSHIPS[key] = m
        shrank = len(m.live) < len(prev_live)
    bump_process("membership_transitions")
    if journal.ACTIVE:
        journal.record(
            "resilience.membership", label=reason, epoch=m.epoch, live_count=len(m.live), world=m.world,
            prev_live_count=len(prev_live),
        )
    _channel_force_healthy(key)
    if shrank:
        _note_shrink(key)
    return m


def reset_membership() -> None:
    """Drop this domain's membership back to the full world, epoch 0."""
    with _STATE_LOCK:
        _MEMBERSHIPS.pop(_current_domain(), None)


# ---------------------------------------------------------------------------
# flap detection
# ---------------------------------------------------------------------------

#: A membership that shrinks again within this many sync rounds is flapping.
FLAP_WINDOW_ROUNDS = 32

_ROUND_COUNTS: Dict[Any, int] = {}
_SHRINK_ROUNDS: Dict[Any, List[int]] = {}


def note_sync_round() -> None:
    """Count one quorum-mode sync round of this domain (the flap window's
    clock)."""
    key = _current_domain()
    with _STATE_LOCK:
        _ROUND_COUNTS[key] = _ROUND_COUNTS.get(key, 0) + 1


def _note_shrink(key: Any) -> None:
    with _STATE_LOCK:
        round_ = _ROUND_COUNTS.get(key, 0)
        rounds = _SHRINK_ROUNDS.setdefault(key, [])
        rounds.append(round_)
        flapping = len(rounds) >= 2 and rounds[-1] - rounds[-2] <= FLAP_WINDOW_ROUNDS
    if flapping:
        from metrics_tpu_torch.observability.diagnostics import warn_once

        warn_once(
            "quorum-flapping",
            "quorum mode shrank the sync membership more than once within "
            f"{FLAP_WINDOW_ROUNDS} rounds: a rank is flapping (repeatedly readmitted and lost). Lengthen the "
            "probation cooldown (METRICS_TPU_PROBATION_COOLDOWN_S or "
            "resilience.configure_probation(base_cooldown_s=...)) so an unstable rank stays out longer.",
        )


# ---------------------------------------------------------------------------
# probation: suspect -> cooldown -> probe -> readmit
# ---------------------------------------------------------------------------

_HEALTHY, _SUSPECT, _PROBE = "healthy", "suspect", "probe"

#: The first probe's cooldown; env knob ``METRICS_TPU_PROBATION_COOLDOWN_S``.
#: Doubled a failed probe, capped at ``max_cooldown_s``.
DEFAULT_PROBATION_COOLDOWN_S = 60.0

_PROBATION = {"base_cooldown_s": None, "max_cooldown_s": 3600.0, "backoff": 2.0}


def configure_probation(
    base_cooldown_s: Optional[float] = None,
    max_cooldown_s: Optional[float] = None,
    backoff: Optional[float] = None,
) -> None:
    """Set the probation knobs for the process."""
    if base_cooldown_s is not None:
        _PROBATION["base_cooldown_s"] = float(base_cooldown_s)
    if max_cooldown_s is not None:
        _PROBATION["max_cooldown_s"] = float(max_cooldown_s)
    if backoff is not None:
        _PROBATION["backoff"] = float(backoff)


def _base_cooldown_s() -> float:
    base = _PROBATION["base_cooldown_s"]
    if base is not None:
        return float(base)
    return float(os.environ.get("METRICS_TPU_PROBATION_COOLDOWN_S", DEFAULT_PROBATION_COOLDOWN_S))


class _ChannelState:
    __slots__ = ("phase", "failures", "cooldown_until", "episode_started")

    def __init__(self) -> None:
        self.phase = _HEALTHY
        self.failures = 0
        self.cooldown_until = 0.0
        self.episode_started = 0.0


_CHANNELS: Dict[Any, _ChannelState] = {}


def _channel(key: Any) -> _ChannelState:
    st = _CHANNELS.get(key)
    if st is None:
        st = _CHANNELS[key] = _ChannelState()
    return st


def channel_is_suspect() -> bool:
    """True while the channel is in probation (suspect or probing)."""
    st = _CHANNELS.get(_current_domain())
    return st is not None and st.phase != _HEALTHY


def mark_channel_suspect() -> None:
    """Enter (or re-enter) probation: from healthy with the base cooldown;
    from a probe round (the probe failed) with the cooldown doubled, capped.
    Journaled once per entry."""
    key = _current_domain()
    with _STATE_LOCK:
        st = _channel(key)
        if st.phase == _SUSPECT:
            return
        failed_probe = st.phase == _PROBE
        if failed_probe:
            st.failures += 1
        else:
            st.failures = 0
            st.episode_started = _now()
        cooldown = min(_base_cooldown_s() * (_PROBATION["backoff"] ** st.failures), _PROBATION["max_cooldown_s"])
        st.phase = _SUSPECT
        st.cooldown_until = _now() + cooldown
    bump_process("channel_suspect_latched")
    if journal.ACTIVE:
        journal.record(
            "health.channel_suspect", label="probe_failed" if failed_probe else "suspect", cooldown_s=cooldown,
            failures=st.failures,
        )


def channel_gate() -> str:
    """The sync's admission: ``"open"`` (healthy), ``"refuse"`` (cooling
    down: raise without touching the channel) or ``"probe"`` (the cooldown
    elapsed: this sync is the probe round)."""
    key = _current_domain()
    with _STATE_LOCK:
        st = _CHANNELS.get(key)
        if st is None or st.phase == _HEALTHY:
            return "open"
        if st.phase == _PROBE:
            return "probe"
        if _now() < st.cooldown_until:
            return "refuse"
        st.phase = _PROBE
    if journal.ACTIVE:
        journal.record("health.channel_probe", failures=st.failures)
    return "probe"


def channel_probe_succeeded() -> None:
    """A probe round's collectives completed: readmit the channel, add the
    episode's length to ``suspect_episode_s`` and journal it."""
    key = _current_domain()
    with _STATE_LOCK:
        st = _CHANNELS.get(key)
        if st is None or st.phase != _PROBE:
            return
        episode_s = max(0.0, _now() - st.episode_started)
        failures = st.failures
        st.phase = _HEALTHY
        st.failures = 0
    add_process("suspect_episode_s", episode_s)
    bump_process("channel_readmits")
    if journal.ACTIVE:
        journal.record("health.channel_readmit", episode_s=episode_s, failures=failures)


def _channel_force_healthy(key: Any) -> None:
    """Drop probation silently (a membership transition is the recovery)."""
    with _STATE_LOCK:
        st = _CHANNELS.get(key)
        if st is not None:
            st.phase = _HEALTHY
            st.failures = 0


def reset_channel_health() -> None:
    """Force the channel healthy: the manual hook for an operator who
    re-established the process group out of band. Optional with probation."""
    key = _current_domain()
    with _STATE_LOCK:
        st = _CHANNELS.get(key)
        if st is None or st.phase == _HEALTHY:
            return
        st.phase = _HEALTHY
        st.failures = 0
    bump_process("channel_resets")
    if journal.ACTIVE:
        journal.record("health.channel_reset")


# ---------------------------------------------------------------------------
# the quorum transport and negotiation
# ---------------------------------------------------------------------------

#: The installed transport (``None`` until a deployment installs one).
_TRANSPORT: Optional[Any] = None


def set_quorum_transport(transport: Optional[Any]) -> None:
    """Install (or clear, with ``None``) the transport quorum negotiation and
    the survivors' gathers ride on."""
    global _TRANSPORT
    _TRANSPORT = transport


def active_subset_transport() -> Optional[Callable[[Any], Any]]:
    """The payload gathers' routing: ``None`` while the membership is whole
    (the default world's collective), else a gather over the survivors."""
    m = _MEMBERSHIPS.get(_current_domain())
    if m is None or not m.degraded or _TRANSPORT is None:
        return None
    live = m.live
    transport = _TRANSPORT
    return lambda x: transport.subset_allgather(x, frozenset(live))


def is_missing_rank_error(err: BaseException) -> bool:
    """Is this sync failure of the missing-rank class (a watchdog timeout, or
    a divergent header, which a dead rank also causes)?
    :func:`negotiate_quorum` probes before shrinking, so a divergence among
    live ranks falls through."""
    return isinstance(err, (SyncTimeoutError, StateDivergenceError))


def _no_transport_warning() -> None:
    from metrics_tpu_torch.observability.diagnostics import warn_once

    warn_once(
        "quorum-no-transport",
        "on_missing='quorum' requested but no quorum transport is installed (resilience.set_quorum_transport): "
        "the default world's collective cannot shrink, so the failure falls through to the on_error policy "
        "unchanged.",
    )


def negotiate_quorum(err: BaseException, *, metric_name: str = "metric") -> Optional[Membership]:
    """Shrink the membership after a missing-rank failure.

    The agreed membership when ranks are missing, else ``None`` (no
    transport, the probe fails, or every member still answers: a divergence
    among live ranks), and the caller raises as without quorum. Symmetric:
    every survivor probes the same fleet, proposes over the same set and
    takes the max.
    """
    if _TRANSPORT is None:
        _no_transport_warning()
        return None
    cur = current_membership()
    try:
        reachable = set(int(r) for r in _TRANSPORT.probe())
    except Exception:  # noqa: BLE001 - a transport that cannot probe cannot help
        return None
    live = sorted(reachable & set(cur.live))
    if not live or set(live) == set(cur.live):
        return None
    proposal = np.asarray([cur.epoch + 1, len(live)], dtype=np.int32)
    try:
        agreed = _to_numpy(_TRANSPORT.negotiate_allgather(proposal, frozenset(live)))
    except SyncError:
        return None
    if agreed.shape[0] != len(live) or not (agreed[:, 1] == len(live)).all():
        raise StateDivergenceError(
            f"quorum negotiation for {metric_name} diverged: survivors disagree on the live set (counts "
            f"{agreed[:, 1].tolist()} vs local {len(live)}). All probing ranks raised together."
        )
    m = advance_membership(live, int(agreed[:, 0].max()), reason="shrink")
    bump_process("quorum_shrinks")
    if journal.ACTIVE:
        journal.record(
            "resilience.quorum", label=metric_name, epoch=m.epoch, live_count=len(m.live), error=type(err).__name__
        )
    return m


def maybe_rejoin(*, metric_name: str = "metric") -> Optional[Membership]:
    """Grow a degraded membership back when lost ranks answer again: run at
    the top of every quorum-mode sync. The recovered rank's local state joins
    the next gather. ``None`` when nothing changed (one dict lookup and no
    collective while the membership is whole)."""
    m = _MEMBERSHIPS.get(_current_domain())
    if m is None or not m.degraded or _TRANSPORT is None:
        return None
    try:
        reachable = set(int(r) for r in _TRANSPORT.probe())
    except Exception:  # noqa: BLE001 - rejoin is opportunistic
        return None
    if not reachable > set(m.live):
        return None
    grown = sorted(reachable | set(m.live))
    proposal = np.asarray([m.epoch + 1, len(grown)], dtype=np.int32)
    try:
        agreed = _to_numpy(_TRANSPORT.negotiate_allgather(proposal, frozenset(grown)))
    except SyncError:
        # a candidate fell away mid-negotiation: stay degraded, probe again
        return None
    if agreed.shape[0] != len(grown) or not (agreed[:, 1] == len(grown)).all():
        return None
    new = advance_membership(grown, int(agreed[:, 0].max()), reason="readmit")
    bump_process("quorum_readmits")
    if journal.ACTIVE:
        journal.record("resilience.quorum", label=metric_name, epoch=new.epoch, live_count=len(new.live), error="")
    return new


# ---------------------------------------------------------------------------
# the adaptive controller
# ---------------------------------------------------------------------------

#: The controller's watchdog timeout (``health.get_sync_timeout`` reads it
#: after an explicit override, before the env knob); ``None`` until set.
_ADAPTIVE_TIMEOUT_S: Optional[float] = None

#: The last committed schedule decisions, by kind.
_SCHEDULE_DECISIONS: Dict[str, Dict[str, Any]] = {}


def adaptive_sync_timeout() -> Optional[float]:
    """The controller's watchdog bound (``None``: not tuning)."""
    return _ADAPTIVE_TIMEOUT_S


def _set_adaptive_timeout(value: Optional[float]) -> None:
    global _ADAPTIVE_TIMEOUT_S
    _ADAPTIVE_TIMEOUT_S = value


def commit_schedule_decision(kind: str, value: Any, *, epoch: int, reason: str = "") -> Any:
    """The one entry of controller decisions that change the collective
    schedule (sync cadence, staleness policy): their inputs must be the same
    on every rank (the membership epoch). Journals and records the decision;
    returns ``value``."""
    with _STATE_LOCK:
        _SCHEDULE_DECISIONS[kind] = {"value": value, "epoch": int(epoch), "reason": reason}
    if journal.ACTIVE:
        journal.record("controller.schedule", label=kind, value=value, epoch=int(epoch), reason=reason)
    return value


def last_schedule_decisions() -> Dict[str, Dict[str, Any]]:
    with _STATE_LOCK:
        return {k: dict(v) for k, v in _SCHEDULE_DECISIONS.items()}


class AdaptiveController:
    """Tunes the watchdog timeout and the schedule from the journal.

    Subscribes to the ``sync``, ``health`` and ``resilience`` event classes
    and keeps an EWMA of gather times (``sync.resolve``'s ``gather_s``, the
    watchdog's ``health.margin`` ``elapsed_s``). The timeout is
    ``max(floor_s, multiplier * ewma)``, committed when it moves by more
    than ``hysteresis`` (relative); a fired watchdog doubles it at once. A
    membership transition commits the sync cadence (2 while degraded) and
    the ``"snapshot"`` staleness policy through
    :func:`commit_schedule_decision`. :meth:`revert` undoes everything.
    """

    def __init__(self, *, floor_s: float = 5.0, multiplier: float = 8.0, alpha: float = 0.2,
                 hysteresis: float = 0.25) -> None:
        self.floor_s = float(floor_s)
        self.multiplier = float(multiplier)
        self.alpha = float(alpha)
        self.hysteresis = float(hysteresis)
        self.ewma_gather_s: Optional[float] = None
        self._subscription: Optional[Any] = None
        self._lock = threading.Lock()

    def start(self) -> "AdaptiveController":
        if self._subscription is None:
            self._subscription = journal.on_event(self._on_event, classes=("sync", "health", "resilience"))
        return self

    def stop(self) -> None:
        sub, self._subscription = self._subscription, None
        if sub is not None:
            sub.close()

    def _on_event(self, event: Any) -> None:
        kind = event.kind
        if kind in ("sync.resolve", "health.margin"):
            gather_s = event.fields.get("gather_s")
            if gather_s is None and kind == "health.margin":
                gather_s = event.fields.get("elapsed_s")
            if gather_s is not None and float(gather_s) > 0:
                self._observe_gather(float(gather_s))
        elif kind == "health.watchdog":
            self._on_watchdog_fired(float(event.fields.get("timeout_s", 0.0)))
        elif kind == "resilience.membership":
            self._on_membership(event.fields)

    def _observe_gather(self, gather_s: float) -> None:
        with self._lock:
            if self.ewma_gather_s is None:
                self.ewma_gather_s = gather_s
            else:
                self.ewma_gather_s += self.alpha * (gather_s - self.ewma_gather_s)
            recommended = max(self.floor_s, self.multiplier * self.ewma_gather_s)
            current = adaptive_sync_timeout()
            move = abs(recommended - current) / current if current else float("inf")
        if move > self.hysteresis:
            self._commit_timeout(recommended, reason="ewma")

    def _on_watchdog_fired(self, fired_timeout_s: float) -> None:
        # the bound was too tight, or a peer is dead: back off at once
        current = adaptive_sync_timeout()
        if current is not None and fired_timeout_s and current <= fired_timeout_s:
            self._commit_timeout(current * 2.0, reason="watchdog_pressure")

    def _on_membership(self, event: Dict[str, Any]) -> None:
        # from symmetric inputs only: the negotiated epoch and counts
        epoch = int(event.get("epoch", 0))
        degraded = int(event.get("live_count", 0)) < int(event.get("world", 0))
        commit_schedule_decision(
            "sync_cadence_multiplier", 2 if degraded else 1, epoch=epoch,
            reason="degraded membership" if degraded else "membership restored",
        )
        commit_schedule_decision(
            "staleness_policy", "snapshot", epoch=epoch,
            reason="pin consistent snapshot serving across a membership change",
        )

    def _commit_timeout(self, value: float, reason: str) -> None:
        _set_adaptive_timeout(float(value))
        set_process("adaptive_timeout_s", float(value))
        if journal.ACTIVE:
            journal.record("controller.timeout", label=reason, timeout_s=float(value),
                           ewma_gather_s=self.ewma_gather_s or 0.0)

    def revert(self) -> None:
        """Undo every committed decision: the adaptive timeout off, the
        schedule decisions cleared (journaled)."""
        _set_adaptive_timeout(None)
        with _STATE_LOCK:
            _SCHEDULE_DECISIONS.clear()
        if journal.ACTIVE:
            journal.record("controller.revert")


def reset_resilience() -> None:
    """Drop all resilience state (memberships, probation, flap windows,
    decisions, the adaptive timeout and the transport)."""
    global _TRANSPORT
    with _STATE_LOCK:
        _MEMBERSHIPS.clear()
        _CHANNELS.clear()
        _ROUND_COUNTS.clear()
        _SHRINK_ROUNDS.clear()
        _SCHEDULE_DECISIONS.clear()
    _TRANSPORT = None
    _set_adaptive_timeout(None)
