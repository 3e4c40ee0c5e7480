"""Cross-process metric-state synchronization on ``torch.distributed``.

Counterpart of the host path of ``metrics_tpu/parallel/sync.py``: each state
leaf is gathered from every rank and reduced by its declared
``dist_reduce_fx``. Uneven leading dims are handled by gathering the shapes,
padding to the largest, gathering and trimming. The backend is the process
group's own: gloo for CPU tensors, NCCL for CUDA tensors (a tensor is gathered
on the device it lives on). A world of one rank is a no-op.

A fixed-capacity ``CatBuffer`` state gathers its (count, overflow flag)
words, then its valid rows (``host_sync_leaf``).

The JAX package's health header, bucketed payload, quorum and tiering layers
are not ported yet; every leaf costs its own collectives here.
"""
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.utils.exceptions import StateDivergenceError, SyncError

ReduceFx = Union[str, Callable, None]

_EPS = 1e-6


def distributed_available(group: Optional[Any] = None) -> bool:
    """More than one process in an initialized ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1


def reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    """Reduce a tensor: 'elementwise_mean' | 'sum' | 'none'."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(
    num: torch.Tensor, denom: torch.Tensor, weights: torch.Tensor, class_reduction: str = "none"
) -> torch.Tensor:
    """Per-class fraction reduction: 'micro' | 'macro' | 'weighted' | 'none'."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    if class_reduction == "micro":
        fraction = torch.sum(num) / (torch.sum(denom) + _EPS)
    else:
        fraction = num / (denom + _EPS)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction in ("none", None):
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")


def _all_gather(x: torch.Tensor, group: Optional[Any]) -> List[torch.Tensor]:
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


def gather_all_arrays(result: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
    """Gather one tensor from every rank; supports uneven shapes.

    Returns one tensor per rank, each trimmed back to that rank's true shape.
    """
    if not distributed_available(group):
        return [result]
    if result.ndim == 0:
        return [p.reshape(()) for p in _all_gather(result.reshape(1), group)]
    local_shape = torch.tensor(result.shape, dtype=torch.long, device=result.device)
    all_shapes = torch.stack(_all_gather(local_shape, group)).cpu()  # [world, ndim]
    if bool((all_shapes == all_shapes[0]).all()):
        return _all_gather(result, group)
    max_shape = all_shapes.amax(dim=0)
    pad = []
    for size, most in reversed(list(zip(result.shape, max_shape.tolist()))):
        pad += [0, most - size]
    padded = torch.nn.functional.pad(result, pad)
    gathered = _all_gather(padded, group)
    return [g[tuple(slice(0, d) for d in shape.tolist())] for g, shape in zip(gathered, all_shapes)]


def host_sync_leaf(value: Any, fx: ReduceFx, group: Optional[Any] = None) -> Any:
    """Sync one state leaf across processes.

    A list state is concatenated locally and gathered whatever its ``fx``.
    Every rank first gathers the element counts, so a rank with an empty list
    still takes part in a collective, and if any rank is empty every rank
    raises :class:`StateDivergenceError` together.

    A :class:`~metrics_tpu_torch.core.cat_buffer.CatBuffer` state gathers one
    (count, overflow flag) word per rank first: an empty rank makes every
    rank raise :class:`StateDivergenceError`, an overflowed one
    :class:`SyncError`. Then the valid rows move through the uneven-shape
    gather, into a ``CatBuffer(world * capacity)`` in rank order.
    """
    from metrics_tpu_torch.core.cat_buffer import CatBuffer

    if isinstance(value, CatBuffer):
        if not distributed_available(group):
            return value.copy()
        word = torch.tensor([len(value), int(value.overflowed)], device=_collective_device(group))
        words = torch.stack(_all_gather(word, group)).cpu()
        if bool((words[:, 0] == 0).any()):
            raise StateDivergenceError(
                "Cannot sync a CatBuffer state across processes: at least one process "
                "has an empty state (no update() before sync()). All processes raised."
            )
        if bool((words[:, 1] != 0).any()):
            raise SyncError(
                "Cannot sync a CatBuffer state across processes: at least one process "
                "overflowed its capacity (rows were overwritten inside jit). "
                "All processes raised. Use a larger `with_capacity(...)`."
            )
        merged = CatBuffer(dist.get_world_size(group) * value.capacity)
        for rows in gather_all_arrays(value.values(), group):
            merged.append(rows)
        return merged
    if isinstance(value, (list, tuple)):
        vals = [torch.cat([v.unsqueeze(0) if v.ndim == 0 else v for v in value])] if value else []
        if not distributed_available(group):
            return vals
        device = vals[0].device if vals else _collective_device(group)
        counts = torch.stack(_all_gather(torch.tensor([len(vals)], device=device), group))
        if bool((counts == 0).any()):
            raise StateDivergenceError(
                "Cannot sync a list-state across processes: at least one process has "
                "an empty state (no update() before sync()). All processes raised."
            )
        return gather_all_arrays(vals[0], group)
    if not distributed_available(group):
        return value
    pieces = gather_all_arrays(value, group)
    if fx == "cat" or fx is None:
        return torch.cat([p.unsqueeze(0) if p.ndim == 0 else p for p in pieces])
    gathered = torch.stack(pieces)
    if fx == "sum":
        return torch.sum(gathered, dim=0)
    if fx == "mean":
        return torch.mean(gathered if gathered.is_floating_point() else gathered.to(torch.float32), dim=0)
    if fx == "max":
        return torch.amax(gathered, dim=0)
    if fx == "min":
        return torch.amin(gathered, dim=0)
    if callable(fx):
        return fx(gathered)
    raise ValueError(f"Unknown dist_reduce_fx {fx!r}")


def _collective_device(group: Optional[Any]) -> torch.device:
    """Where a collective of ``group`` must place its tensors: the current CUDA
    device under NCCL, the host otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_sync_state(
    state: Dict[str, Any], reductions: Dict[str, ReduceFx], group: Optional[Any] = None
) -> Dict[str, Any]:
    """Sync a whole metric-state dict across processes, leaf by leaf in the
    dict's order (the same on every rank, since every rank declares the same
    states)."""
    return {name: host_sync_leaf(value, reductions.get(name), group) for name, value in state.items()}
