"""Error types for API misuse and cross-process sync failures.

Counterpart of ``metrics_tpu/utils/exceptions.py``, cut to the classes this
package raises. The names are the JAX package's, so code written against one
package catches the same errors from the other.
"""


class MetricsTPUUserError(Exception):
    """Raised when the API is used incorrectly (e.g. double-sync)."""


class SyncError(RuntimeError):
    """Base class for cross-process metric-state synchronization failures.

    Raised *symmetrically*: every rank sees the same gathered evidence and
    takes the same raise branch, so a fault never strands a peer inside a
    collective.
    """


class SyncTimeoutError(SyncError):
    """A host collective did not complete within the watchdog timeout.

    The usual cause is a dead or stalled peer process. After this is raised
    the process's collective ordering can no longer be trusted: recover via
    ``on_error="local"`` degradation or by restarting the process group.
    """


class StateDivergenceError(SyncError):
    """Metric state diverged across processes before a sync.

    Covers the divergence classes the health word detects: a rank with an
    empty cat-state, mismatched state schemas (names/dtypes/item shapes),
    and update-count skew under strict checking.
    """


class StaleSyncError(SyncError):
    """An overlapped (non-blocking) sync resolved against a moved-on state.

    Raised under ``staleness_policy="fresh"`` when ``update()`` ran between
    a round's launch and its resolve: the full local accumulation is
    restored first; degrade with ``on_error="local"``, resolve earlier, or
    accept bounded staleness with ``"snapshot"``/``"merge"``
    (``parallel/async_sync.py``).
    """


class NonFiniteStateError(SyncError):
    """A rank's accumulated state was poisoned by NaN/Inf values.

    Raised when ``check_finite`` screening is enabled and any participating
    rank's poison flag is set (or locally, single-process, at compute time).
    """


class StateSchemaError(MetricsTPUUserError):
    """Two metric states that must share a schema do not.

    Raised by ``Metric.merge_state`` before any state is touched, naming
    every divergent leaf.
    """


class StateDictMismatchError(MetricsTPUUserError):
    """``load_state_dict(strict=True)`` found missing or unexpected keys.

    Raised before any state is mutated, listing both the declared states the
    snapshot lacks and the snapshot keys no declared state claims.
    """


class CheckpointError(RuntimeError):
    """Base class for durable metric-checkpoint failures.

    Covers everything that can go wrong between a snapshot directory and a
    resumed metric: no usable snapshot, unsupported manifest versions, and
    (via :class:`CheckpointCorruptError`) byte-level corruption.
    """


class CheckpointCorruptError(CheckpointError):
    """A checkpoint file failed integrity verification.

    Raised when any byte-level check fails — bad magic, header or per-leaf
    CRC mismatch, truncation, impossible offsets. The loader verifies the
    whole file *before* mutating any metric state, so a corrupt checkpoint
    can never partially resume: the typed error is the only outcome.
    """


#: The source library's name for :class:`MetricsTPUUserError`, kept for
#: users migrating from it.
TorchMetricsUserError = MetricsTPUUserError
