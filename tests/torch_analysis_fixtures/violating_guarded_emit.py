"""metricslint fixture (torch twin, line for line): guarded-telemetry-emit —
journal emissions that would record on some ranks only (skewed journals).

The CI gate asserts the CLI exits NONZERO on this file. ``record`` mirrors
``metrics_tpu_torch.observability.journal.record`` (the pass keys on the call
name); the stubs keep the module import-safe.
"""
import torch.distributed as dist


class _journal:  # stand-in for metrics_tpu_torch.observability.journal
    ACTIVE = False

    @staticmethod
    def record(kind, label="", step=-1, **fields):
        return None


journal = _journal()


def rank_gated_emit(x):
    """finding: guarded-telemetry-emit — only rank 0 journals the event, so
    peer journals diverge and cross-rank correlation breaks."""
    if dist.get_rank() == 0:
        journal.record("sync.launch", label="m", sync_epoch=1)
    return x


def data_gated_emit(state, x):
    """finding: guarded-telemetry-emit — ranks whose local state is empty
    skip the event their peers record."""
    if len(state) > 0:
        journal.record("sync.resolve", label="m", sync_epoch=1)
    return x


def active_gated_emit_is_clean(x):
    """no finding: the recorder's own enable flag is symmetric config — the
    canonical `if journal.ACTIVE:` hot-path guard must never be flagged."""
    if journal.ACTIVE:
        journal.record("sync.drain", label="m", sync_epoch=1)
    return x


def _emit_helper(kind):
    """a local wrapper around record(): transitively recorder-emitting."""
    journal.record(kind, label="m", sync_epoch=1)


def rank_gated_emit_via_helper(x):
    """finding: guarded-telemetry-emit — wrapping the emission in a local
    helper must not defeat the guard-free contract (the pass propagates
    recorder emission through the intra-module call graph, exactly like the
    collective-emission fixpoint)."""
    if dist.get_rank() == 0:
        _emit_helper("sync.launch")
    return x
