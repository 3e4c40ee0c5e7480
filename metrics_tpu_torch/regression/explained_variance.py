"""ExplainedVariance module metric.

Counterpart of ``metrics_tpu/regression/explained_variance.py``. The five
states are declared 0-d and take the shape of one batch's moments at the
first update: ``[D]`` for ``[N, D]`` input, by broadcasting the 0-d state
against the batch's ``[D]`` sums, as in the JAX package. ``reset()``
restores the 0-d defaults; ``forward``'s merge and the sum sync work on
whatever shape the states hold.
"""
from typing import Any, Callable, Optional, Sequence, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.explained_variance import (
    _explained_variance_compute,
    _explained_variance_update,
)


class ExplainedVariance(Metric):
    r"""Explained variance :math:`1 - \frac{\mathrm{Var}(y - \hat{y})}{\mathrm{Var}(y)}`:
    like R², but blind to a constant offset of the predictions.

    Args:
        multioutput: ``"uniform_average"`` / ``"raw_values"`` /
            ``"variance_weighted"`` collapse of per-output scores.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Raises:
        ValueError: unknown ``multioutput``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ExplainedVariance
        >>> explained_variance = ExplainedVariance(device="cpu")
        >>> round(float(explained_variance(torch.tensor([3.0, -0.5, 2.0, 7.0]), torch.tensor([2.5, 0.0, 2.0, 8.0]))), 4)
        0.9645
    """

    is_differentiable = True

    def __init__(
        self,
        multioutput: str = "uniform_average",
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
        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput
        self.add_state("sum_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_squared_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_target", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_squared_target", torch.tensor(0.0), dist_reduce_fx="sum")
        # a float count, as in the JAX package
        self.add_state("n_obs", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(
            preds, target
        )
        self.n_obs = self.n_obs + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> Union[torch.Tensor, Sequence[torch.Tensor]]:
        return _explained_variance_compute(
            self.n_obs,
            self.sum_error,
            self.sum_squared_error,
            self.sum_target,
            self.sum_squared_target,
            self.multioutput,
        )
