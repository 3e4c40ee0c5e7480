"""Faults planted under the timed path, for the gate's tests: each breaks
the port's collection in one way that a sound check must catch."""
import torch


def _halve(x: torch.Tensor) -> torch.Tensor:
    # half of the batch, or of each image's rows when the batch is one
    return x[: x.shape[0] // 2] if x.shape[0] > 1 else x[..., : x.shape[-1] // 2]


def plant(fault: str) -> None:
    """Patch ``MetricCollection`` in this process with ``fault``."""
    from metrics_tpu_torch.core.collections import MetricCollection

    update, compute = MetricCollection.update, MetricCollection.compute
    if fault == "state_unchanged":
        MetricCollection.update = lambda self, *args, **kwargs: None
    elif fault == "half_batch":
        MetricCollection.update = lambda self, preds, target: update(self, _halve(preds), _halve(target))
    elif fault == "answer_altered":
        def altered(self):
            values = compute(self)
            key = sorted(values)[0]
            values[key] = values[key] + 1e-3
            return values
        MetricCollection.compute = altered
    else:
        raise ValueError(fault)

