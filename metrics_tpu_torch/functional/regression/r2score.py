"""Deprecated alias of :func:`r2_score`.

Counterpart of ``metrics_tpu/functional/regression/r2score.py``. As there,
the package re-export rebinds the ``regression.r2score`` attribute to the
function, so reach it with ``from metrics_tpu_torch.functional import r2score``.
"""
from warnings import warn

import torch

from metrics_tpu_torch.functional.regression.r2 import r2_score


def r2score(
    preds: torch.Tensor,
    target: torch.Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    """Deprecated alias of :func:`r2_score`: warns, then calls it.

    Example:
        >>> import warnings
        >>> import torch
        >>> from metrics_tpu_torch.functional import r2score
        >>> with warnings.catch_warnings():
        ...     warnings.simplefilter("ignore", DeprecationWarning)
        ...     round(float(r2score(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.9486
    """
    warn(
        "`functional.r2score` was renamed to `functional.r2_score` and will be removed.",
        DeprecationWarning,
    )
    return r2_score(preds, target, adjusted, multioutput)
