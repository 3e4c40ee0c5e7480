"""CohenKappa module metric.

Counterpart of ``metrics_tpu/classification/cohen_kappa.py``: an int64
``[C, C]`` confusion-matrix "sum" state.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute, _cohen_kappa_update


class CohenKappa(Metric):
    r"""Cohen's kappa :math:`\kappa = \frac{p_o - p_e}{1 - p_e}`: agreement
    of predictions and targets, less the agreement ``p_e`` that two raters
    with the same marginals reach by chance (1 perfect, 0 chance).

    Args:
        num_classes: number of classes ``C``.
        weights: ``None`` for plain kappa; ``"linear"``/``"quadratic"``
            weigh a disagreement by the (squared) label distance.
        threshold: binarization cut for probabilistic input.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CohenKappa
        >>> cohenkappa = CohenKappa(num_classes=2, device="cpu")
        >>> round(float(cohenkappa(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 0, 0, 1]))), 4)
        0.5
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: int,
        weights: Optional[str] = None,
        threshold: float = 0.5,
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
        self.num_classes = num_classes
        self.weights = weights
        self.threshold = threshold

        allowed_weights = ("linear", "quadratic", "none", None)
        if self.weights not in allowed_weights:
            raise ValueError(f"Argument weights needs to one of the following: {allowed_weights}")
        self.add_state(
            "confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.long), dist_reduce_fx="sum"
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        self.confmat = self.confmat + _cohen_kappa_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> torch.Tensor:
        return _cohen_kappa_compute(self.confmat, self.weights)
