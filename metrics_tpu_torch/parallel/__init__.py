"""Cross-process sync: the health-checked host sync, its bucketed payload,
the watchdog and the channel latch; the overlapped rounds
(``parallel/async_sync.py``) and the in-program collectives
(``sync_in_jit``, ``sync_leaf_in_jit``).

The JAX package's quorum, probation and adaptive controller
(``parallel/resilience.py``; ROADMAP A10.2) and tiering (A10.3) are not
ported yet.
"""
from metrics_tpu_torch.parallel.async_sync import (
    STALENESS_POLICIES,
    AsyncSyncRound,
    drain_round,
    launch_round,
    resolve_round,
    sync_channel,
)
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
    jit_distributed_available,
    reduce,
    sync_in_jit,
    sync_leaf_in_jit,
)

__all__ = [
    "AsyncSyncRound",
    "NONFINITE_STATE",
    "STALENESS_POLICIES",
    "SyncPlan",
    "build_health_word",
    "build_sync_plan",
    "call_with_sync_watchdog",
    "channel_is_suspect",
    "class_reduce",
    "clear_sync_plan_cache",
    "distributed_initialize_with_retry",
    "drain_round",
    "fused_sync_enabled",
    "gather_all_arrays",
    "get_sync_timeout",
    "host_sync_leaf",
    "host_sync_state",
    "host_sync_state_bucketed",
    "jit_distributed_available",
    "launch_round",
    "mark_channel_suspect",
    "reduce",
    "reset_channel_health",
    "resolve_round",
    "sync_channel",
    "sync_in_jit",
    "sync_leaf_in_jit",
    "sync_plan_cache_info",
    "verify_health_words",
]
