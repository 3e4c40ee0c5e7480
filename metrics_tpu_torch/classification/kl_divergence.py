"""KLDivergence module metric.

Counterpart of ``metrics_tpu/classification/kl_divergence.py``: a sum state
for ``"mean"``/``"sum"``, a "cat" state of per-sample values for ``"none"``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.utils.data import dim_zero_cat


class KLDivergence(Metric):
    r"""KL divergence :math:`D_{KL}(P\|Q) = \sum_x P(x)\log\frac{P(x)}{Q(x)}`
    between paired distributions ``p`` and ``q``, accumulated over batches.

    Args:
        log_prob: the inputs are log-probabilities (no normalization or
            clamping).
        reduction: ``"mean"`` (default) / ``"sum"`` over samples, or
            ``"none"``/``None`` for the per-sample values.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KLDivergence
        >>> kl = KLDivergence(device="cpu")
        >>> round(float(kl(torch.tensor([[0.36, 0.48, 0.16]]), torch.tensor([[1 / 3, 1 / 3, 1 / 3]]))), 4)
        0.0853
    """

    is_differentiable = True
    _weak_dtype_states = ("measures",)

    def __init__(
        self,
        log_prob: bool = False,
        reduction: Optional[str] = "mean",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        allowed_reduction = ["mean", "sum", "none", None]
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.log_prob = log_prob
        self.reduction = reduction
        if self.reduction in ["mean", "sum"]:
            self.add_state("measures", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, p: torch.Tensor, q: torch.Tensor) -> None:  # type: ignore[override]
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + torch.sum(measures)
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        measures = dim_zero_cat(self.measures) if self.reduction in ("none", None) else self.measures
        return _kld_compute(measures, self.total, self.reduction)
