"""R2Score module metric.

Counterpart of ``metrics_tpu/regression/r2.py``: four streaming moments per
output (Σy², Σy, the residual sum) as float32 "sum" states and an int64
count (int32 in the JAX package).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.r2 import _r2_score_compute, _r2_score_update


class R2Score(Metric):
    r"""R² (coefficient of determination): the fraction of target variance
    the predictions explain; 1 is perfect, 0 the mean-predictor baseline.

    Args:
        num_outputs: number of regression outputs ``D`` (default 1).
        adjusted: degrees-of-freedom correction for this many regressors
            (see :func:`~metrics_tpu_torch.functional.r2_score`).
        multioutput: ``"uniform_average"`` / ``"raw_values"`` /
            ``"variance_weighted"`` collapse of the per-output scores.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Raises:
        ValueError: negative ``adjusted`` or unknown ``multioutput``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import R2Score
        >>> r2 = R2Score(device="cpu")
        >>> round(float(r2(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.9486
    """

    is_differentiable = True

    def __init__(
        self,
        num_outputs: int = 1,
        adjusted: int = 0,
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
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput
        shape = () if num_outputs == 1 else (num_outputs,)
        self.add_state("sum_squared_error", torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("sum_error", torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("residual", torch.zeros(shape), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )
