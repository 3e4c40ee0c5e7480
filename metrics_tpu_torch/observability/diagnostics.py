"""One-time diagnostics with a dedupe key.

Counterpart of ``metrics_tpu/observability/diagnostics.py``:

- :func:`warn_once` warns once per *dedupe key* (any hashable; per-instance
  and per-class once-semantics are key choices, as the compute-group
  planner's ``("group-static-hazard", cls)``);
- :func:`diag` prints one structured JSON diagnostic line on stderr;
- :func:`seen` and :func:`reset` read and clear the dedupe memory.

``warn_once`` records no journal event; a call site with a fact worth
journaling records its own typed event beside the warning.
"""
import json
import sys
import threading
import warnings
from typing import Any, Hashable, Optional

from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["diag", "reset", "seen", "warn_once"]

_seen: set = set()
_lock = threading.Lock()


def warn_once(
    key: Hashable,
    message: str,
    category: type = UserWarning,
    *,
    every_rank: bool = False,
    stacklevel: int = 3,
) -> bool:
    """Warn once per ``key`` in this process. Returns ``True`` when this call
    warned (the first for its key), ``False`` when deduped.

    ``every_rank=True`` warns on every process; the default warns on rank
    zero only, as :func:`rank_zero_warn`. The key is consumed before the
    rank gate, so a later identical warning never appears on one rank only.
    """
    with _lock:
        if key in _seen:
            return False
        _seen.add(key)
    if every_rank:
        warnings.warn(message, category, stacklevel=stacklevel)
    else:
        rank_zero_warn(message, category, stacklevel=stacklevel + 1)
    return True


def seen(key: Hashable) -> bool:
    """Has ``key``'s one-time diagnostic fired?"""
    with _lock:
        return key in _seen


def reset(key: Optional[Hashable] = None) -> None:
    """Forget one dedupe key, or all of them."""
    with _lock:
        if key is None:
            _seen.clear()
        else:
            _seen.discard(key)


def diag(**kv: Any) -> None:
    """One structured JSON diagnostic line on stderr: ``{"diagnostic": {...}}``."""
    print(json.dumps({"diagnostic": kv}, default=str), file=sys.stderr)
