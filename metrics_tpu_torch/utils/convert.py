"""Carry metric state across from the JAX package.

The counterpart, for a metrics library, of carrying a model's weights across:
a ``metrics_tpu`` metric's (or collection's) ``state_dict()`` — numpy arrays
and lists of them — becomes a dict this package's ``load_state_dict`` takes.
"""
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.utils.device import resolve_device


# half-precision states (after the JAX metric's ``set_dtype``) keep their dtype
_HALF = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _tensor(x: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind in "iu":
        # the JAX package counts in int32 (x64 off); this package in int64
        return torch.as_tensor(arr.astype(np.int64), device=device)
    if arr.dtype.kind == "f" or arr.dtype.name in _HALF:
        # widening to float32 is exact; a half state narrows back exactly
        return torch.as_tensor(arr.astype(np.float32), device=device).to(_HALF.get(arr.dtype.name, torch.float32))
    return torch.as_tensor(arr, device=device)


def state_dict_from_reference(
    sd: Dict[str, Any], device: Optional[Union[str, torch.device]] = None
) -> Dict[str, Any]:
    """Turn a ``metrics_tpu`` ``state_dict()`` into one for ``load_state_dict``.

    Integer states become int64, float16 and bfloat16 states keep their
    dtype, other floating states become float32, list states stay lists (of
    converted tensors), and a fixed-capacity CatBuffer snapshot becomes a
    :class:`~metrics_tpu_torch.core.cat_buffer.CatBuffer` with its flag.
    Shapes carry over as they are: a state that took a batch's ``[D]``
    shape (ExplainedVariance) and a ``dist_reduce_fx=None`` state gathered
    to ``[W]`` by a sync (PearsonCorrcoef's moments, whose float32 count
    stays float32) load and compute as they would in the JAX package.
    ``device=None`` means CUDA, as everywhere in this package.
    """
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for key, value in sd.items():
        if isinstance(value, dict) and "__catbuffer__" in value:
            out[key] = _cat_buffer(value, dev)
        elif isinstance(value, dict):
            raise ValueError(f"state {key!r} is a dict but not a CatBuffer snapshot")
        else:
            out[key] = [_tensor(v, dev) for v in value] if isinstance(value, (list, tuple)) else _tensor(value, dev)
    return out


def _cat_buffer(snapshot: Dict[str, Any], device: torch.device) -> CatBuffer:
    """A JAX ``{"__catbuffer__": capacity, "buffer", "count", "overflowed"}``
    snapshot as a CatBuffer of this package: its valid rows, converted as
    any state is, in a zeroed buffer of the same capacity. The overflow
    flag carries over (absent in old snapshots: clean), so an accumulation
    that overflowed inside ``jit`` stays loud here."""
    cb = CatBuffer(int(snapshot["__catbuffer__"]))
    count = int(np.asarray(snapshot["count"]))
    if snapshot["buffer"] is not None and count:
        cb.append(_tensor(np.asarray(snapshot["buffer"])[:count], device))
    cb.overflowed = bool(np.asarray(snapshot.get("overflowed", False)))
    return cb
