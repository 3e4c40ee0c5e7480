"""Tweedie deviance score — functional layer.

Counterpart of ``metrics_tpu/functional/regression/tweedie_deviance.py``.
The power selects the branch on the host; the value-domain checks read the
data (one host read each), as the JAX package's eager path does.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, _is_concrete


def _tweedie_deviance_score_update(
    preds: torch.Tensor, targets: torch.Tensor, power: float = 0.0
) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, targets)
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")

    # the domain checks read the data: eager only, as in the JAX package
    concrete = _is_concrete(preds, targets)
    if power == 0:
        deviance_score = (targets - preds) ** 2
    elif power == 1:
        if concrete and (bool(torch.any(preds <= 0)) or bool(torch.any(targets < 0))):
            raise ValueError(
                f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative."
            )
        deviance_score = 2 * (targets * torch.log(targets / preds) + preds - targets)
    elif power == 2:
        if concrete and (bool(torch.any(preds <= 0)) or bool(torch.any(targets <= 0))):
            raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
        deviance_score = 2 * (torch.log(preds / targets) + targets / preds - 1)
    else:
        if concrete:
            if power < 0 and bool(torch.any(preds <= 0)):
                raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
            if 1 < power < 2 and (bool(torch.any(preds <= 0)) or bool(torch.any(targets < 0))):
                raise ValueError(
                    f"For power={power}, 'targets' has to be strictly positive and 'preds' cannot be negative."
                )
            if power > 2 and (bool(torch.any(preds <= 0)) or bool(torch.any(targets <= 0))):
                raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
        term_1 = torch.clamp(targets, min=0) ** (2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * preds ** (1 - power) / (1 - power)
        term_3 = preds ** (2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)

    return torch.sum(deviance_score), deviance_score.numel()


def _tweedie_deviance_score_compute(sum_deviance_score: torch.Tensor, num_observations) -> torch.Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: torch.Tensor, targets: torch.Tensor, power: float = 0.0) -> torch.Tensor:
    r"""Tweedie deviance: Gaussian (0), Poisson (1), Gamma (2) or compound.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import tweedie_deviance_score
        >>> round(float(tweedie_deviance_score(torch.tensor([2.0, 0.5]), torch.tensor([1.0, 1.0]), power=0.0)), 4)
        0.625
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
