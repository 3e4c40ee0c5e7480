"""TweedieDevianceScore module metric.

Counterpart of ``metrics_tpu/regression/tweedie_deviance.py``: a float32
deviance sum and an int64 count named ``num_observations`` (int32 in the
JAX package).
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)


class TweedieDevianceScore(Metric):
    r"""Mean Tweedie deviance, the family of GLM losses set by ``power``:

    - ``power = 0``: squared error (normal);
    - ``power = 1``: Poisson deviance (counts);
    - ``power = 2``: Gamma deviance (strictly positive, multiplicative);
    - other values: compound Poisson–Gamma and stable families.

    The input domain follows the power (``power=1`` needs strictly positive
    preds and non-negative targets, ``power=2`` strictly positive both); a
    violation raises at ``update``, and ``0 < power < 1`` is undefined.

    Args:
        power: the family selector above.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TweedieDevianceScore
        >>> deviance = TweedieDevianceScore(power=1.0, device="cpu")
        >>> round(float(deviance(torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([1.5, 2.5, 3.5, 4.5]))), 4)
        0.1178
    """

    is_differentiable = True

    def __init__(
        self,
        power: float = 0.0,
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
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_observations", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, targets: torch.Tensor) -> None:  # type: ignore[override]
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> torch.Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
