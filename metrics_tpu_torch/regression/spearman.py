"""SpearmanCorrcoef module metric.

Counterpart of ``metrics_tpu/regression/spearman.py``: two "cat" states,
ranked at ``compute()``. Under ``with_capacity(n)`` they are CatBuffers, and
``compute()`` reads their valid rows with no host read.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class SpearmanCorrcoef(Metric):
    r"""Spearman rank correlation: the Pearson correlation of the
    tie-averaged ranks, which measures any monotonic association in [-1, 1].

    Ranking needs every sample at once, so the values accumulate as "cat"
    states and the ranks are taken at ``compute()``; memory grows with the
    stream (or is fixed up front with ``with_capacity``).

    Args:
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import warnings
        >>> import torch
        >>> from metrics_tpu_torch import SpearmanCorrcoef
        >>> with warnings.catch_warnings():
        ...     warnings.simplefilter("ignore")
        ...     spearman = SpearmanCorrcoef(device="cpu")
        >>> round(float(spearman(torch.tensor([2.0, 2.0, 2.0, 2.0, 6.0]), torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]))), 4)
        0.7071
    """

    is_differentiable = False

    def __init__(
        self,
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
        rank_zero_warn(
            "Metric `SpearmanCorrcoef` will save all targets and predictions in the buffer."
            " For large datasets, this may lead to a large memory footprint."
        )
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        preds, target = _spearman_corrcoef_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _spearman_corrcoef_compute(preds, target)
