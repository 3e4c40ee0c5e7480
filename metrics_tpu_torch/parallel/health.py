"""The health-checked sync header of the host sync, and its liveness guards.

Counterpart of ``metrics_tpu/parallel/health.py``. Before any payload moves,
every rank contributes one fixed-width int32 *health word* per sync in a
single ``all_gather``::

    [version, schema_hash, update_count, overflow, nonfinite, n_states,
     sync_epoch, member_epoch, live_count, tier, precision,
     count_0 ... count_{COUNT_SLOTS-1},
     len_0 ... len_{CAT_LENGTH_SLOTS-1}]

- ``schema_hash`` is a CRC32 over the state schema (names, kinds, dtypes,
  item shapes, reductions; leading "data" dims of cat states excluded), over
  this package's own dtype names, so it need not equal the JAX package's;
- ``update_count``: ``update()`` calls folded into the state;
- ``overflow``: any CatBuffer's sticky overflow flag;
- ``nonfinite``: the ``check_finite`` poison verdict (0 when screening is off);
- ``n_states``: number of declared states (the poison flag included);
- ``sync_epoch``: the overlapped round this gather belongs to, 0 for a
  blocking sync (``parallel/async_sync.py`` sets it per round), so a rank
  resolving a background round never pairs with a peer's foreground sync;
- ``member_epoch`` and ``live_count``: the negotiated quorum membership
  (``parallel/resilience.py``; a sync over another process group reports
  that group's size);
- ``tier``: this rank's tier id under the tier map, -1 without one or over
  another process group (``parallel/tiering.py``); the verifier holds the
  gathered column to :func:`~metrics_tpu_torch.parallel.tiering.expected_tier_column`;
- ``precision``: the slow hop's ``sync_precision`` code
  (``parallel/quantize.py``);
- ``count_j``: participation count of the j-th state (sorted by name);
- ``len_j``: row count of the j-th cat-family state, which the bucketed
  planner (``parallel/bucketing.py``) reads to size its ragged buffers.

The word has the same width for every metric, so the header gather is
well-formed even when ranks disagree about what they sync; every rank then
runs :func:`verify_health_words` over the same gathered ``[world, width]``
matrix and raises the same typed exception, or none.

The module also holds the liveness guard :func:`call_with_sync_watchdog`
(``METRICS_TPU_SYNC_TIMEOUT_S``, default 600 s, 0 disables) and the
channel-suspect functions, which delegate to the probation state machine of
``parallel/resilience.py``.
"""
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple, TypeVar

import numpy as np
import torch

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.parallel import resilience
from metrics_tpu_torch.observability.registry import bump_process, set_process
from metrics_tpu_torch.utils.exceptions import (
    NonFiniteStateError,
    StateDivergenceError,
    SyncError,
    SyncTimeoutError,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "HEALTH_PROTOCOL_VERSION",
    "COUNT_SLOTS",
    "CAT_LENGTH_SLOTS",
    "WORD_WIDTH",
    "NONFINITE_STATE",
    "FUSED_KEY_SEP",
    "build_health_word",
    "call_with_sync_watchdog",
    "cat_family_names",
    "cat_row_count",
    "channel_is_suspect",
    "fingerprint_crc",
    "get_sync_timeout",
    "header_cat_lengths",
    "is_missing_rank_error",
    "mark_channel_suspect",
    "reset_channel_health",
    "state_has_nonfinite",
    "state_poisoned",
    "state_schema_hash",
    "state_schema_parts",
    "verify_health_words",
]

T = TypeVar("T")

#: The JAX package's protocol revision, whose word layout this is.
HEALTH_PROTOCOL_VERSION = 5

#: Reserved state name of the ``check_finite`` poison flag: an int32 scalar
#: with ``dist_reduce_fx="sum"``.
NONFINITE_STATE = "_nonfinite"

#: Separator of a collection's combined member states
#: (``<member key>\\x1f<state name>``); the poison verdict sees through it.
FUSED_KEY_SEP = "\x1f"

_F_VERSION = 0
_F_SCHEMA = 1
_F_UPDATES = 2
_F_OVERFLOW = 3
_F_NONFINITE = 4
_F_NSTATES = 5
_F_EPOCH = 6
_F_MEMBER_EPOCH = 7
_F_LIVE = 8
_F_TIER = 9
_F_PRECISION = 10
_F_FIXED = 11

#: Per-state count slots; unused slots hold -1.
COUNT_SLOTS = 16
_F_LENGTHS = _F_FIXED + COUNT_SLOTS

#: Per-cat-state row-length slots; unused slots hold -1.
CAT_LENGTH_SLOTS = 16
WORD_WIDTH = _F_LENGTHS + CAT_LENGTH_SLOTS

#: Watchdog default (seconds); env knob ``METRICS_TPU_SYNC_TIMEOUT_S``, 0 = off.
DEFAULT_SYNC_TIMEOUT_S = 600.0


def get_sync_timeout(override: Optional[float] = None) -> float:
    """Effective watchdog timeout: the explicit override, else the adaptive
    controller's (``resilience.AdaptiveController``), else the
    ``METRICS_TPU_SYNC_TIMEOUT_S`` env knob, else 600 s. The watchdog only
    bounds how long this rank waits, so a rank-local value is safe."""
    if override is not None:
        return float(override)
    adaptive = resilience.adaptive_sync_timeout()
    if adaptive is not None:
        return float(adaptive)
    return float(os.environ.get("METRICS_TPU_SYNC_TIMEOUT_S", DEFAULT_SYNC_TIMEOUT_S))


def _state_kinds(state: Dict[str, Any]) -> Tuple[List[str], Dict[str, str]]:
    """(sorted names, kind per name); kinds are 'catbuf' | 'list' | 'leaf'."""
    names = sorted(state)
    kinds = {}
    for name in names:
        v = state[name]
        if isinstance(v, CatBuffer):
            kinds[name] = "catbuf"
        elif isinstance(v, (list, tuple)):
            kinds[name] = "list"
        else:
            kinds[name] = "leaf"
    return names, kinds


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def state_schema_parts(state: Dict[str, Any], reductions: Dict[str, Any]) -> str:
    """The canonical schema string the word's CRC covers, and the key of the
    bucketed sync plan cache: names, kinds, dtypes, item shapes and declared
    reductions. Leading dims of cat-family states are left out, so uneven
    per-rank batches serialize equal."""
    parts = []
    for name in sorted(state):
        v = state[name]
        fx = reductions.get(name)
        fx_tag = fx if isinstance(fx, str) or fx is None else "callable"
        if isinstance(v, CatBuffer):
            item = "?" if v.buffer is None else f"{_dtype_name(v.buffer.dtype)}{tuple(v.buffer.shape[1:])}"
            parts.append(f"{name}|catbuf|{item}|{fx_tag}")
        elif isinstance(v, (list, tuple)):
            if len(v):
                first = torch.as_tensor(v[0])
                item = f"{_dtype_name(first.dtype)}{tuple(first.shape[1:])}"
            else:
                item = "?"
            parts.append(f"{name}|list|{item}|{fx_tag}")
        else:
            arr = torch.as_tensor(v)
            shape = tuple(arr.shape[1:]) if fx in ("cat", None) else tuple(arr.shape)
            parts.append(f"{name}|leaf|{_dtype_name(arr.dtype)}{shape}|{fx_tag}")
    return ";".join(parts)


def state_schema_hash(state: Dict[str, Any], reductions: Dict[str, Any]) -> int:
    """Stable 31-bit CRC over :func:`state_schema_parts`."""
    return zlib.crc32(state_schema_parts(state, reductions).encode()) & 0x7FFFFFFF


def fingerprint_crc(fingerprint: Any) -> int:
    """Stable 31-bit CRC over a ``Metric.state_fingerprint()`` tuple, with
    callable reductions (compared by ``id`` in process) masked to the tag
    ``"callable"``: equal across save and restore of one configuration."""

    def _mask(part: Any) -> Any:
        if isinstance(part, tuple):
            if len(part) == 2 and part[0] == "callable" and isinstance(part[1], int):
                return "callable"
            return tuple(_mask(p) for p in part)
        return part

    return zlib.crc32(repr(_mask(fingerprint)).encode()) & 0x7FFFFFFF


def _is_cat_family(kind: str, fx: Any) -> bool:
    """Does this state gather rows (vs reduce)? CatBuffer and list states
    always do; tensor leaves only for ``fx`` in ``("cat", None)``."""
    if kind in ("catbuf", "list"):
        return True
    return fx == "cat" or fx is None


def cat_family_names(state: Dict[str, Any], reductions: Dict[str, Any]) -> List[str]:
    """Sorted names of the cat-family states: the order of the header's
    ``len_j`` columns and of the bucketed planner's ragged leaves."""
    names, kinds = _state_kinds(state)
    return [n for n in names if _is_cat_family(kinds[n], reductions.get(n))]


def cat_row_count(value: Any, kind: str) -> int:
    """Rows this rank contributes to a cat-family state's gathered payload:
    a CatBuffer's fill count, a list's rows over its batches (a scalar entry
    is one row), a tensor's leading dim (a scalar is one row)."""
    if kind == "catbuf":
        return int(value.count)
    if kind == "list":
        return int(sum(1 if torch.as_tensor(v).ndim == 0 else torch.as_tensor(v).shape[0] for v in value))
    arr = torch.as_tensor(value)
    return 1 if arr.ndim == 0 else int(arr.shape[0])


def header_cat_lengths(words: np.ndarray, n_cat: int) -> Optional[np.ndarray]:
    """Per-rank row counts ``[world, n_cat]`` from the header's length
    columns, or ``None`` past ``CAT_LENGTH_SLOTS`` cat-family states (the
    planner then gathers one length vector)."""
    if n_cat > CAT_LENGTH_SLOTS:
        return None
    return np.asarray(words)[:, _F_LENGTHS:_F_LENGTHS + n_cat]


def _element_count(value: Any, kind: str) -> int:
    """Participation count: a CatBuffer's rows, a list's batches (a rank
    whose one batch had zero rows still takes part), a tensor's size."""
    if kind == "catbuf":
        return int(value.count)
    if kind == "list":
        return len(value)
    return int(torch.as_tensor(value).numel())


def state_has_nonfinite(state: Dict[str, Any]) -> bool:
    """Exact scan: any NaN/Inf among the float leaves of ``state``, the poison
    flag itself excluded. Reads the device once per float leaf."""

    def _bad(x: Any) -> bool:
        x = torch.as_tensor(x)
        return bool((x.is_floating_point() or x.is_complex()) and not bool(torch.isfinite(x).all()))

    for name, v in state.items():
        if name == NONFINITE_STATE:
            continue
        if isinstance(v, CatBuffer):
            if bool(v.has_nonfinite()):
                return True
        elif isinstance(v, (list, tuple)):
            if any(_bad(x) for x in v):
                return True
        elif _bad(v):
            return True
    return False


def state_poisoned(state: Dict[str, Any]) -> bool:
    """The poison verdict shared by the health word, the single-process
    compute guard and the degradation warning: the latched per-update flag OR
    the whole-state scan. ``False`` when no flag state was registered. Sees
    through a collection's combined keys (:data:`FUSED_KEY_SEP`): each
    member's flag gates only that member's states."""
    groups: Dict[str, Dict[str, Any]] = {}
    for name, value in state.items():
        prefix, _, leaf = name.rpartition(FUSED_KEY_SEP)
        groups.setdefault(prefix, {})[leaf] = value
    for group in groups.values():
        flag = group.get(NONFINITE_STATE)
        if flag is None:
            continue
        if int(torch.as_tensor(flag)) > 0 or state_has_nonfinite(group):
            return True
    return False


def build_health_word(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    update_count: int = 0,
    world: Optional[int] = None,
    sync_epoch: int = 0,
    sync_precision: Any = None,
) -> np.ndarray:
    """This rank's int32 health word ``[WORD_WIDTH]`` for one state dict.

    ``world`` is the size of the process group a sync runs over when that is
    not the default world: it fills ``live_count`` and the tier column is -1
    (tiers are ranks of the default world). ``None`` (the default world)
    reads the membership and the tier map, as the JAX package does.
    ``sync_epoch`` is the round's, ``sync_precision`` the slow hop's codec.
    """
    from metrics_tpu_torch.parallel.quantize import precision_code, validate_sync_precision
    from metrics_tpu_torch.parallel.tiering import my_tier_id

    names, kinds = _state_kinds(state)
    overflow = int(any(kinds[n] == "catbuf" and state[n].overflowed for n in names))
    nonfinite = int(state_poisoned(state))
    counts = [_element_count(state[name], kinds[name]) for name in names]
    slots = [-1] * COUNT_SLOTS
    if len(counts) <= COUNT_SLOTS:
        slots[: len(counts)] = counts
    else:
        slots[: COUNT_SLOTS - 1] = counts[: COUNT_SLOTS - 1]
        # the tail folds into the last slot: the minimum of its cat-family
        # counts (the only kind whose zero is a divergence), -1 when none
        tail_cat = [
            c for c, name in zip(counts[COUNT_SLOTS - 1:], names[COUNT_SLOTS - 1:])
            if kinds[name] in ("catbuf", "list")
        ]
        slots[COUNT_SLOTS - 1] = min(tail_cat) if tail_cat else -1
    length_slots = [-1] * CAT_LENGTH_SLOTS
    cat_names = [n for n in names if _is_cat_family(kinds[n], reductions.get(n))]
    for j, name in enumerate(cat_names[:CAT_LENGTH_SLOTS]):
        length_slots[j] = cat_row_count(state[name], kinds[name])
    word = [
        HEALTH_PROTOCOL_VERSION,
        state_schema_hash(state, reductions),
        int(update_count),
        overflow,
        nonfinite,
        len(names),
        int(sync_epoch),
        int(resilience.membership_epoch()),
        int(resilience.live_count() if world is None else world),
        int(my_tier_id() if world is None else -1),
        precision_code(validate_sync_precision(sync_precision)),
    ] + slots + length_slots
    return np.asarray(word, dtype=np.int32)


def verify_health_words(
    words: np.ndarray,
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    *,
    strict_update_count: bool = False,
    metric_name: str = "metric",
    subgroup: bool = False,
) -> None:
    """Verify the gathered ``[world, width]`` health words.

    Deterministic over input that is the same on every rank, so every rank
    raises the same typed exception, or none. The checks and their order are
    the JAX package's: emptiness before schema, so that an empty rank (whose
    unknown item spec perturbs the hash) gets the "no update() before
    sync()" message. ``subgroup`` (a sync over a process group that is not
    the default world) expects the tier column all -1.
    """
    words = np.asarray(words)
    world = words.shape[0]
    names, kinds = _state_kinds(state)
    if words.shape[1] != WORD_WIDTH:
        raise StateDivergenceError(
            f"health word width mismatch for {metric_name}: got {words.shape[1]}, "
            f"expected {WORD_WIDTH}: ranks are running different "
            "metrics_tpu versions. All processes raised."
        )

    versions = words[:, _F_VERSION]
    if not (versions == HEALTH_PROTOCOL_VERSION).all():
        raise StateDivergenceError(
            f"sync-header protocol version skew for {metric_name}: "
            f"{sorted(set(versions.tolist()))}: ranks are running different "
            "metrics_tpu versions. All processes raised."
        )

    epochs = words[:, _F_EPOCH]
    if not (epochs == epochs[0]).all():
        raise StateDivergenceError(
            f"sync-round skew for {metric_name}: per-rank sync epochs "
            f"{epochs.tolist()} differ: ranks disagree whether (or which) "
            "overlapped sync round this collective belongs to. All "
            "processes raised together."
        )

    member_epochs = words[:, _F_MEMBER_EPOCH]
    live_counts = words[:, _F_LIVE]
    if not (member_epochs == member_epochs[0]).all() or not (live_counts == live_counts[0]).all():
        raise StateDivergenceError(
            f"membership skew for {metric_name}: per-rank membership epochs "
            f"{member_epochs.tolist()} / live counts {live_counts.tolist()} "
            "differ: ranks disagree which membership this collective runs "
            "over. All processes raised together."
        )

    # every rank derives the expected tier column from the negotiated live
    # set and its own map: an asymmetric map cannot match every rank's
    # expectation, so the tier schedule is refused before any payload moves
    from metrics_tpu_torch.parallel.tiering import expected_tier_column

    tiers = words[:, _F_TIER]
    expected_tiers = None if subgroup else expected_tier_column(world)
    tier_ok = (
        (tiers == -1).all()
        if expected_tiers is None
        else expected_tiers.shape[0] == world and (tiers == expected_tiers).all()
    )
    if not tier_ok:
        raise StateDivergenceError(
            f"tier-topology skew for {metric_name}: gathered tier column {tiers.tolist()} does not match this "
            f"rank's expected {'flat world (all -1)' if expected_tiers is None else expected_tiers.tolist()}: "
            "ranks disagree on the tier map (asymmetric METRICS_TPU_TIER_SIZE / set_tier_map, or tiering "
            "configured on only some ranks). All processes raised together."
        )

    precisions = words[:, _F_PRECISION]
    if not (precisions == precisions[0]).all():
        raise StateDivergenceError(
            f"sync-precision skew for {metric_name}: per-rank payload "
            f"precision codes {precisions.tolist()} differ (0=full, 1=bf16, "
            "2=int8): ranks would mix encodings in one exchange. All processes "
            "raised together."
        )

    nstates = words[:, _F_NSTATES]
    if not (nstates == len(names)).all():
        raise StateDivergenceError(
            f"State-count mismatch for {metric_name}: per-rank state counts "
            f"{nstates.tolist()} vs local {len(names)}: ranks are running "
            "different metric definitions. All processes raised together."
        )

    for j, name in enumerate(names[: COUNT_SLOTS - 1]):
        if kinds[name] not in ("catbuf", "list"):
            continue
        col = words[:, _F_FIXED + j]
        if (col == 0).any():
            empty = np.nonzero(col == 0)[0].tolist()
            raise StateDivergenceError(
                f"Cannot sync state {name!r} of {metric_name} across {world} "
                f"processes: process(es) {empty} have an empty state (no "
                "update() before sync()). All processes raised together."
            )
    if len(names) > COUNT_SLOTS - 1 and any(kinds[name] in ("catbuf", "list") for name in names[COUNT_SLOTS - 1:]):
        col = words[:, _F_FIXED + COUNT_SLOTS - 1]
        if (col == 0).any():
            empty = np.nonzero(col == 0)[0].tolist()
            raise StateDivergenceError(
                f"Cannot sync {metric_name} across {world} processes: "
                f"process(es) {empty} have an empty state beyond count slot "
                f"{COUNT_SLOTS - 1} (no update() before sync()). All "
                "processes raised together."
            )

    if (words[:, _F_OVERFLOW] != 0).any():
        bad = np.nonzero(words[:, _F_OVERFLOW] != 0)[0].tolist()
        raise SyncError(
            f"Cannot sync {metric_name} across processes: process(es) {bad} "
            "overflowed a CatBuffer capacity (rows were overwritten inside "
            "jit). All processes raised. Use a larger `with_capacity(...)`."
        )

    if (words[:, _F_NONFINITE] != 0).any():
        bad = np.nonzero(words[:, _F_NONFINITE] != 0)[0].tolist()
        raise NonFiniteStateError(
            f"Cannot sync {metric_name} across processes: process(es) {bad} "
            "accumulated non-finite (NaN/Inf) state values (check_finite "
            "screening). All processes raised together."
        )

    schemas = words[:, _F_SCHEMA]
    if not (schemas == schemas[0]).all():
        raise StateDivergenceError(
            f"State-schema mismatch for {metric_name}: ranks disagree on state "
            "names/dtypes/item shapes/reductions (schema hashes "
            f"{sorted(set(schemas.tolist()))}). The payload gather would be "
            "ill-formed; all processes raised together."
        )

    updates = words[:, _F_UPDATES]
    if not (updates == updates[0]).all():
        msg = f"update-count skew for {metric_name}: per-rank update() counts {updates.tolist()} differ before sync."
        if strict_update_count:
            raise StateDivergenceError(msg + " All processes raised (strict mode).")
        rank_zero_warn(
            msg + " Proceeding (uneven feeds are legal); pass strict_update_count=True to make this fatal.",
            RuntimeWarning,
        )


#: The missing-rank class (a watchdog timeout, or a divergent header, which
#: a dead rank also causes): what ``on_missing`` acts on.
is_missing_rank_error = resilience.is_missing_rank_error


# ---------------------------------------------------------------------------
# Liveness guards: the sync watchdog and the channel's probation
# ---------------------------------------------------------------------------

# A fired watchdog puts the channel in probation (``parallel/resilience.py``):
# the abandoned worker may still sit inside its collective, so the next syncs
# refuse; after a cooldown one probe round goes through, and its success
# readmits the channel. These names delegate there.


def channel_is_suspect() -> bool:
    """True while the channel is in probation (a watchdog fired and no probe
    round has succeeded yet): host syncs refuse."""
    return resilience.channel_is_suspect()


def mark_channel_suspect() -> None:
    """Enter probation (the watchdog's and the overlapped rounds' one entry):
    a failed probe round re-enters with the cooldown doubled."""
    resilience.mark_channel_suspect()


def reset_channel_health() -> None:
    """Force the channel healthy at once (an operator who re-established the
    process group); with probation a suspect channel also heals itself."""
    resilience.reset_channel_health()


def call_with_sync_watchdog(fn: Callable[[], T], *, timeout: Optional[float] = None, what: str = "host collective") -> T:
    """Run ``fn`` on a daemon worker thread and wait at most ``timeout``
    seconds for it (``None`` reads ``METRICS_TPU_SYNC_TIMEOUT_S``, default
    600, unless the adaptive controller set one; 0 or less calls ``fn``
    inline).

    A collective blocked on a dead or stalled peer would block forever; here
    it raises :class:`SyncTimeoutError` and puts the channel in probation
    (the worker cannot be cancelled and is left to die with the process). A fired
    watchdog bumps the process counter ``watchdog_fired`` and journals
    ``health.watchdog``; a finished collective sets ``watchdog_margin_s``
    (the timeout minus its time on the host's clock) and journals
    ``health.margin``.
    """
    timeout = get_sync_timeout(timeout)
    if timeout <= 0:
        return fn()
    box: Dict[str, Any] = {}

    def _run() -> None:
        try:
            box["value"] = fn()
        except BaseException as err:  # noqa: BLE001 - re-raised on the caller thread
            box["error"] = err

    worker = threading.Thread(target=_run, name=f"metrics-tpu-watchdog[{what}]", daemon=True)
    started = time.monotonic()
    worker.start()
    worker.join(timeout)
    if worker.is_alive():
        bump_process("watchdog_fired")
        if journal.ACTIVE:
            journal.record("health.watchdog", label=what, timeout_s=timeout)
        mark_channel_suspect()
        raise SyncTimeoutError(
            f"{what} did not complete within {timeout:g}s: a peer process is "
            "likely dead or stalled. Raise METRICS_TPU_SYNC_TIMEOUT_S for slow "
            "interconnects, or recover with Metric.sync(on_error='local')."
        )
    elapsed = time.monotonic() - started
    set_process("watchdog_margin_s", timeout - elapsed)
    if journal.ACTIVE:
        journal.record("health.margin", label=what, elapsed_s=elapsed, timeout_s=timeout, margin_s=timeout - elapsed)
    if "error" in box:
        raise box["error"]
    return box["value"]


def distributed_initialize_with_retry(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    max_retries: int = 5,
    base_backoff_s: float = 0.5,
    initialize_fn: Optional[Callable[..., None]] = None,
    **kwargs: Any,
) -> None:
    """``torch.distributed.init_process_group`` with exponential-backoff retry.

    Counterpart of the JAX package's ``jax.distributed.initialize`` wrapper,
    with its arguments: ``coordinator_address`` is the rendezvous
    (``host:port``, or a full ``init_method`` such as ``tcp://host:port``),
    ``num_processes`` the world size and ``process_id`` this rank; the other
    keywords (``backend``, ``timeout``, ...) go to the initializer.

    Binding the coordinator races (the probed free port can be taken by
    another process) and ranks that dial before the coordinator listens see
    connection errors. Both are transient: retried with exponential backoff,
    staggered by rank (deterministic, no RNG). Other errors re-raise at once;
    an exhausted budget raises :class:`SyncTimeoutError` chained to the last
    error. ``initialize_fn`` replaces ``init_process_group`` (tests).
    """
    if initialize_fn is None:
        initialize_fn = torch.distributed.init_process_group
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    transient_markers = (
        "address already in use",
        "connection refused",
        "failed to connect",
        "unavailable",
        "deadline exceeded",
        "bind",
        "timed out",
    )
    last_err: Optional[BaseException] = None
    for attempt in range(max_retries + 1):
        try:
            initialize_fn(init_method=init_method, world_size=num_processes, rank=process_id, **kwargs)
            return
        except Exception as err:  # noqa: BLE001 - classified below
            text = str(err).lower()
            if not any(marker in text for marker in transient_markers):
                raise
            last_err = err
            if attempt == max_retries:
                break
            # stagger ranks so they do not collide again on the same port
            time.sleep(base_backoff_s * (2**attempt) * (1.0 + 0.1 * (process_id % 8)))
    raise SyncTimeoutError(
        f"torch.distributed.init_process_group({init_method!r}, rank {process_id}/"
        f"{num_processes}) failed after {max_retries + 1} attempts: {last_err}"
    ) from last_err
