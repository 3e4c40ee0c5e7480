"""Tensor utilities shared by every metric.

Counterpart of ``metrics_tpu/utils/data.py``: the state reducers
(``dim_zero_*``), one-hot encoding, top-k binarization, class inference, the
confusion matrix's scatter count, the threshold grid of the binned metrics,
the host-side query grouping and ``apply_to_collection``.
"""
from collections.abc import Mapping
from typing import TYPE_CHECKING, Any, Callable, List, Optional, Union

import torch

from metrics_tpu_torch.utils.prints import rank_zero_warn

if TYPE_CHECKING:
    from metrics_tpu_torch.core.cat_buffer import CatBuffer

METRIC_EPS = 1e-6


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor], "CatBuffer"]) -> torch.Tensor:
    """Concatenate a (possibly list- or CatBuffer-valued) state along dim 0."""
    from metrics_tpu_torch.core.cat_buffer import CatBuffer

    if isinstance(x, CatBuffer):
        if x.buffer is None or len(x) == 0:
            raise ValueError("No samples to concatenate")
        return x.values()
    x = list(x) if isinstance(x, (list, tuple)) else [x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat([y.unsqueeze(0) if y.ndim == 0 else y for y in x], dim=0)


def dim_zero_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: torch.Tensor) -> torch.Tensor:
    # jnp.mean of an integer array is float32 (x64 off); torch.mean refuses ints
    return torch.mean(x if x.is_floating_point() else x.to(torch.float32), dim=0)


def dim_zero_max(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(x, dim=0)


def dim_zero_min(x: torch.Tensor) -> torch.Tensor:
    return torch.amin(x, dim=0)


def to_onehot(label_tensor: torch.Tensor, num_classes: Optional[int] = None) -> torch.Tensor:
    """Convert integer labels ``[N, d1, ...]`` to one-hot ``[N, C, d1, ...]``."""
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1  # data-dependent
    classes = torch.arange(num_classes, device=label_tensor.device)
    classes = classes.reshape((num_classes,) + (1,) * label_tensor.ndim)
    onehot = (label_tensor.unsqueeze(0) == classes).long()
    return torch.movedim(onehot, 0, 1)  # [C, N, ...] -> [N, C, ...]


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """Binarize scores: 1 where a value is among the top-k along ``dim``.

    k=1 is an argmax one-hot, as in the JAX package: ``torch.argmax`` and
    ``jnp.argmax`` agree on ties (first maximum) and on NaN (first NaN).
    """
    moved = torch.movedim(prob_tensor, dim, -1)
    if topk == 1:
        mask = torch.nn.functional.one_hot(torch.argmax(moved, dim=-1), moved.shape[-1])
    else:
        idx = torch.topk(moved, topk, dim=-1).indices
        mask = torch.zeros(moved.shape, dtype=torch.long, device=moved.device).scatter_(-1, idx, 1)
    return torch.movedim(mask, -1, dim)


def to_categorical(tensor: torch.Tensor, argmax_dim: int = 1) -> torch.Tensor:
    """Probabilities/one-hot ``[N, C, ...]`` -> integer labels ``[N, ...]``."""
    return torch.argmax(tensor, dim=argmax_dim)


def get_num_classes(preds: torch.Tensor, target: torch.Tensor, num_classes: Optional[int] = None) -> int:
    """Infer the number of classes from the data (reads two values on the
    host), warning when ``num_classes`` disagrees with it."""
    num_target_classes = int(torch.max(target)) + 1
    num_pred_classes = int(torch.max(preds)) + 1
    num_all_classes = max(num_target_classes, num_pred_classes)
    if num_classes is None:
        num_classes = num_all_classes
    elif num_classes != num_all_classes:
        rank_zero_warn(
            f"You have set {num_classes} number of classes which is different from predicted "
            f"({num_pred_classes}) and target ({num_target_classes}) number of classes",
            RuntimeWarning,
        )
    return num_classes


def _bincount(x: torch.Tensor, minlength: int) -> torch.Tensor:
    """int64 counts of each value of ``x`` in ``[0, minlength)``, with the JAX
    package's ``zeros(minlength).at[x].add(1)`` semantics: a negative index
    wraps once (``-1`` counts into the last bin), and an index still outside
    the range is dropped.

    Unlike ``torch.bincount`` it never reads the data on the host, and it
    never scatters out of range (on CUDA that is a device-side assert):
    dropped indices add 0 to bin 0. Integer atomics commute, so the counts
    are exact in any order.
    """
    x = x.reshape(-1).long()
    x = torch.where(x < 0, x + minlength, x)
    keep = (x >= 0) & (x < minlength)
    out = torch.zeros(minlength, dtype=torch.long, device=x.device)
    return out.index_add_(0, torch.where(keep, x, torch.zeros_like(x)), keep.long())


def _linspace_like_reference(num: int) -> torch.Tensor:
    """``num`` float32 thresholds evenly spaced in [0, 1], bit for bit those of
    the JAX package's ``jnp.linspace(0, 1.0, num)``.

    ``torch.linspace`` rounds differently (for num=100 one value of 100
    differs, for 101 twenty). XLA computes ``iota * (1 / (num - 1))`` in
    float32 and appends the endpoint; this repeats that arithmetic. Built on
    the CPU; move it where it is needed.
    """
    if num < 1:
        raise ValueError(f"Expected a positive number of thresholds, got {num}")
    if num == 1:
        return torch.zeros(1, dtype=torch.float32)
    step = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(num - 1), dtype=torch.float32)
    head = torch.arange(num - 1, dtype=torch.float32) * step
    return torch.cat([head, torch.ones(1, dtype=torch.float32)])


def get_group_indexes(indexes: torch.Tensor) -> List[torch.Tensor]:
    """Group row positions by query id (host-side, ragged output), in the
    order each id first appears; int32 positions on the CPU, as the JAX
    package's. The retrieval metrics group on the device instead
    (``ops/segment.py``)."""
    res: dict = {}
    for i, idx in enumerate(indexes.reshape(-1).tolist()):
        res.setdefault(idx, []).append(i)
    return [torch.tensor(x, dtype=torch.int32) for x in res.values()]


def apply_to_collection(
    data: Any,
    dtype: Union[type, tuple],
    function: Callable,
    *args: Any,
    wrong_dtype: Optional[Union[type, tuple]] = None,
    **kwargs: Any,
) -> Any:
    """Recursively apply ``function`` to all ``dtype`` leaves of a collection
    (mappings, namedtuples, lists, tuples and CatBuffers; a CatBuffer's count
    and flag are host values, passed to ``function`` as the JAX package
    passes its count and flag arrays when they match ``dtype``)."""
    from metrics_tpu_torch.core.cat_buffer import CatBuffer

    def recurse(d: Any) -> Any:
        return apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs)

    if isinstance(data, dtype) and (wrong_dtype is None or not isinstance(data, wrong_dtype)):
        return function(data, *args, **kwargs)
    if isinstance(data, CatBuffer):
        return CatBuffer(
            data.capacity,
            None if data.buffer is None else recurse(data.buffer),
            recurse(data.count),
            recurse(data.overflowed),
        )
    if isinstance(data, Mapping):
        return type(data)({k: recurse(v) for k, v in data.items()})
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return type(data)(*(recurse(d) for d in data))
    if isinstance(data, (list, tuple)):
        return type(data)(recurse(d) for d in data)
    return data


def allclose(a: torch.Tensor, b: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    """``torch.allclose`` as a Python ``bool`` (reads the device once)."""
    return bool(torch.allclose(a, b, rtol=rtol, atol=atol))
