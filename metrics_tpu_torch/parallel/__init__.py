"""Cross-process sync: the health-checked host sync, its bucketed payload,
the watchdog and the channel latch.

The JAX package's overlapped rounds (``AsyncSyncRound``, ``launch_round``,
``resolve_round``, ``drain_round``, ``STALENESS_POLICIES``; ROADMAP A10.1),
quorum, probation and the adaptive controller (``parallel/resilience.py``;
A10.2) and the in-``jit`` collectives (``sync_in_jit``, ``sync_leaf_in_jit``,
``jit_distributed_available``; A9.3) are not ported yet.
"""
from metrics_tpu_torch.parallel.bucketing import (
    SyncPlan,
    build_sync_plan,
    clear_sync_plan_cache,
    fused_sync_enabled,
    host_sync_state_bucketed,
    sync_plan_cache_info,
)
from metrics_tpu_torch.parallel.health import (
    NONFINITE_STATE,
    build_health_word,
    call_with_sync_watchdog,
    channel_is_suspect,
    distributed_initialize_with_retry,
    get_sync_timeout,
    mark_channel_suspect,
    reset_channel_health,
    verify_health_words,
)
from metrics_tpu_torch.parallel.sync import (
    class_reduce,
    gather_all_arrays,
    host_sync_leaf,
    host_sync_state,
    reduce,
)

__all__ = [
    "NONFINITE_STATE",
    "SyncPlan",
    "build_health_word",
    "build_sync_plan",
    "call_with_sync_watchdog",
    "channel_is_suspect",
    "class_reduce",
    "clear_sync_plan_cache",
    "distributed_initialize_with_retry",
    "fused_sync_enabled",
    "gather_all_arrays",
    "get_sync_timeout",
    "host_sync_leaf",
    "host_sync_state",
    "host_sync_state_bucketed",
    "mark_channel_suspect",
    "reduce",
    "reset_channel_health",
    "sync_plan_cache_info",
    "verify_health_words",
]
