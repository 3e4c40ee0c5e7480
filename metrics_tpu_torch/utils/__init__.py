"""Helpers shared by the metrics: state reductions, one-hot and top-k, the
enums, the exceptions and rank-zero logging. ``compile_cache`` (the XLA disk
cache) has no counterpart here."""
from metrics_tpu_torch.utils.data import (
    METRIC_EPS,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    get_group_indexes,
    select_topk,
    to_categorical,
    to_onehot,
)
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, EnumStr, MDMCAverageMethod
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError, TorchMetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_only, rank_zero_warn

__all__ = [
    "METRIC_EPS",
    "AverageMethod",
    "DataType",
    "EnumStr",
    "MDMCAverageMethod",
    "MetricsTPUUserError",
    "TorchMetricsUserError",
    "apply_to_collection",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "get_group_indexes",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_only",
    "rank_zero_warn",
    "select_topk",
    "to_categorical",
    "to_onehot",
]
