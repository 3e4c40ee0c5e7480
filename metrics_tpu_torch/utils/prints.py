"""Rank-zero gated warnings and logging (counterpart of ``metrics_tpu/utils/prints.py``)."""
import logging
import warnings
from functools import partial, wraps
from typing import Any, Callable

import torch.distributed as dist

log = logging.getLogger("metrics_tpu_torch")


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Call ``fn`` on process 0 only; a no-op returning ``None`` elsewhere."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


def rank_zero_warn(message: str, *args: Any, stacklevel: int = 3, **kwargs: Any) -> None:
    """``warnings.warn`` on process 0 only; a no-op on the other ranks."""
    if _rank() == 0:
        warnings.warn(message, *args, stacklevel=stacklevel, **kwargs)


@rank_zero_only
def rank_zero_info(message: str, *args: Any, **kwargs: Any) -> None:
    log.info(message, *args, **kwargs)


@rank_zero_only
def rank_zero_debug(message: str, *args: Any, **kwargs: Any) -> None:
    log.debug(message, *args, **kwargs)


#: ``rank_zero_warn`` with ``category=DeprecationWarning``.
rank_zero_deprecation = partial(rank_zero_warn, category=DeprecationWarning)
