"""CosineSimilarity module metric.

Counterpart of ``metrics_tpu/regression/cosine_similarity.py``: two float32
"cat" states, concatenated at ``compute()`` (CatBuffers under
``with_capacity(n)``).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from metrics_tpu_torch.utils.data import dim_zero_cat


class CosineSimilarity(Metric):
    r"""Cosine similarity between paired vectors: the angle, not the
    magnitude. 1-D inputs are one vector pair (concatenated across batches
    at ``compute()``); N-D inputs score one similarity per last-axis row.

    Args:
        reduction: ``"sum"`` / ``"mean"`` over the per-row similarities,
            or ``"none"``/``None`` for the vector.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CosineSimilarity
        >>> cosine = CosineSimilarity(reduction="mean", device="cpu")
        >>> round(float(cosine(torch.tensor([[1.0, 2.0, 3.0, 4.0]]), torch.tensor([[1.0, 2.0, 3.0, 4.0]]))), 4)
        1.0
    """

    is_differentiable = True

    def __init__(
        self,
        reduction: Optional[str] = "sum",
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
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        preds, target = _cosine_similarity_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _cosine_similarity_compute(preds, target, self.reduction)
