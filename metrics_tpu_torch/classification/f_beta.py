"""FBeta and F1 module metrics.

Counterpart of ``metrics_tpu/classification/f_beta.py``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.classification.precision_recall import _AveragedStatScores
from metrics_tpu_torch.functional.classification.f_beta import _fbeta_compute


class FBeta(_AveragedStatScores):
    r"""F-beta score :math:`(1+\beta^2)\frac{P \cdot R}{\beta^2 P + R}`:
    ``beta < 1`` leans toward precision, ``beta > 1`` toward recall,
    ``beta = 1`` is :class:`F1`. The other arguments are those of
    :class:`~metrics_tpu_torch.Precision`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import FBeta
        >>> f_beta = FBeta(num_classes=4, beta=0.5, device="cpu")
        >>> round(float(f_beta(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))), 4)
        0.5
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        beta: float = 1.0,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            threshold=threshold,
            average=average,
            mdmc_average=mdmc_average,
            ignore_index=ignore_index,
            top_k=top_k,
            multiclass=multiclass,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.beta = beta

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _fbeta_compute(tp, fp, tn, fn, self.beta, self.ignore_index, self.average, self.mdmc_reduce)


class F1(FBeta):
    """F1, the harmonic mean of precision and recall: :class:`FBeta` with
    ``beta = 1``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import F1
        >>> f1 = F1(num_classes=4, device="cpu")
        >>> round(float(f1(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]))), 4)
        0.5
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            beta=1.0,
            threshold=threshold,
            average=average,
            mdmc_average=mdmc_average,
            ignore_index=ignore_index,
            top_k=top_k,
            multiclass=multiclass,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
