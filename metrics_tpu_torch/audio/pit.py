"""PIT module metric.

Counterpart of ``metrics_tpu/audio/pit.py``: a float32 sum of the best
per-sample values and an int64 count (int32 in the JAX package, which
widens on load).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.pit import pit


class PIT(Metric):
    """Permutation-invariant training metric wrapper.

    Forward accepts ``preds``/``target`` of shape ``[batch, spk, ...]``; the
    wrapped pairwise ``metric_func`` is evaluated under the best speaker
    permutation per sample (see :func:`metrics_tpu_torch.functional.audio.pit`).

    Args:
        metric_func: batched pairwise metric ``(preds, target) -> [batch]``.
        eval_func: ``'max'`` or ``'min'`` — whether larger metric is better.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.
        kwargs: extra args forwarded to ``metric_func``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PIT
        >>> from metrics_tpu_torch.functional.audio import si_snr
        >>> preds = torch.tensor([[[-0.0579, 0.3560, -0.9604], [-0.1719, 0.3205, 0.2951]]])
        >>> target = torch.tensor([[[1.0958, -0.1648, 0.5228], [-0.4100, 1.1942, -0.5103]]])
        >>> round(float(PIT(si_snr, 'max', device="cpu")(preds, target)), 4)
        3.222
    """

    is_differentiable = True

    def __init__(
        self,
        metric_func: Callable,
        eval_func: str = "max",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs
        self.add_state("sum_pit_metric", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        best_metric = pit(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self.sum_pit_metric = self.sum_pit_metric + torch.sum(best_metric)
        self.total = self.total + best_metric.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_pit_metric / self.total
