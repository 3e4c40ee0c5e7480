from metrics_tpu_torch.parallel.sync import (
    class_reduce,
    gather_all_arrays,
    host_sync_leaf,
    host_sync_state,
    reduce,
)

__all__ = ["class_reduce", "gather_all_arrays", "host_sync_leaf", "host_sync_state", "reduce"]
