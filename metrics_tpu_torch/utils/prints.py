"""Rank-zero gated warnings (counterpart of ``metrics_tpu/utils/prints.py``)."""
import warnings
from functools import partial
from typing import Any

import torch.distributed as dist


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_warn(message: str, *args: Any, stacklevel: int = 3, **kwargs: Any) -> None:
    """``warnings.warn`` on process 0 only; a no-op on the other ranks."""
    if _rank() == 0:
        warnings.warn(message, *args, stacklevel=stacklevel, **kwargs)


#: ``rank_zero_warn`` with ``category=DeprecationWarning``.
rank_zero_deprecation = partial(rank_zero_warn, category=DeprecationWarning)
