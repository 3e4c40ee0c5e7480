"""Deprecated import path of :class:`R2Score`.

Counterpart of ``metrics_tpu/regression/r2score.py``: constructing the
class from this module warns (``DeprecationWarning``, on rank zero) and
builds the real metric.
"""
from typing import Any

from metrics_tpu_torch.regression.r2 import R2Score as _R2Score
from metrics_tpu_torch.utils.prints import rank_zero_deprecation


class R2Score(_R2Score):
    """Deprecated alias of :class:`metrics_tpu_torch.regression.r2.R2Score`.

    Example:
        >>> import warnings
        >>> import torch
        >>> from metrics_tpu_torch.regression.r2score import R2Score
        >>> with warnings.catch_warnings():
        ...     warnings.simplefilter("ignore", DeprecationWarning)
        ...     r2 = R2Score(device="cpu")
        >>> r2.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(r2.compute()), 4)
        0.9486
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        rank_zero_deprecation(
            "`metrics_tpu_torch.regression.r2score.R2Score` is a deprecated alias;"
            " import `R2Score` from `metrics_tpu_torch` instead."
        )
        super().__init__(*args, **kwargs)
