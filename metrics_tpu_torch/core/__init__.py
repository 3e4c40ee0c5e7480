from metrics_tpu_torch.core.average import AverageMeter
from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.core.checkpoint import (
    MetricCheckpointer,
    load_checkpoint,
    prune_checkpoints,
    register_manifest_migration,
    save_checkpoint,
)
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric

__all__ = [
    "AverageMeter",
    "CatBuffer",
    "CompositionalMetric",
    "Metric",
    "MetricCheckpointer",
    "MetricCollection",
    "load_checkpoint",
    "prune_checkpoints",
    "register_manifest_migration",
    "save_checkpoint",
]
