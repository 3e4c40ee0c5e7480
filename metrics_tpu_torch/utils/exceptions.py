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


class StateDivergenceError(SyncError):
    """Metric state diverged across processes before a sync (e.g. one rank
    holds an empty list state)."""


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
