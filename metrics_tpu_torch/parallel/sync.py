"""Cross-process metric-state synchronization on ``torch.distributed``.

Counterpart of the host path of ``metrics_tpu/parallel/sync.py``: each state
leaf is gathered from every rank and reduced by its declared
``dist_reduce_fx``. Uneven leading dims are handled by gathering the shapes,
padding to the largest, gathering and trimming. A world of one rank is a
no-op.

A whole state syncs through :func:`host_sync_state`: one health-header
gather that every rank verifies (``parallel/health.py``), then the bucketed
payload (``parallel/bucketing.py``), or the per-leaf path. Every collective
goes through one seam, :func:`_all_gather`, under the sync watchdog, and
crosses on :func:`_collective_device`: the card under NCCL, the host under
gloo, whatever device the state lives on. A foreground sync first drains the
overlapped rounds this process launched (``parallel/async_sync.py``), and a
round's sync carries its epoch in the header.

**In-program collectives** (:func:`sync_in_jit`, :func:`sync_leaf_in_jit`)
are the counterpart of the JAX package's ``psum``/``all_gather`` inside
``shard_map``: ``torch.distributed``'s functional collectives, which a CUDA
graph (over an NCCL group) or ``torch.compile`` can hold, and which gloo runs
on the CPU. ``axis_name`` is what they take as a group: a ``ProcessGroup``,
a 1-D ``DeviceMesh``, ``(DeviceMesh, dim)`` (a tuple of dims: the group that
spans them) or a list of ranks. Each runs through one seam,
:func:`_program_collective`, which waits on its result before it is read.
No health header and no watchdog run there: they are host code, as the JAX
package's in-``jit`` sync has neither.

**Quorum** (``on_missing="quorum"``, ``parallel/resilience.py``): a sync
that loses ranks negotiates the survivors and runs again over them; once
the membership is degraded, every default-world gather of :func:`_gather`
routes through the installed transport's ``subset_allgather`` over the
survivors (same watchdog), and the world a gather spans is
``resilience.effective_world()``. Quorum runs over the default world: with
another ``process_group`` it raises :class:`MetricsTPUUserError` (the JAX
package's host sync takes no group at all). The in-program sync takes no
part in quorum, as the JAX package's ``psum`` over a mesh axis does not: it
runs over the group its axis names.
"""
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.parallel.health import build_health_word, call_with_sync_watchdog, verify_health_words
from metrics_tpu_torch.utils.exceptions import (
    MetricsTPUUserError,
    StateDivergenceError,
    SyncError,
    SyncTimeoutError,
)

ReduceFx = Union[str, Callable, None]

#: Accepted ``on_missing`` policies.
ON_MISSING_MODES = ("raise", "quorum", "local")

_EPS = 1e-6


def distributed_available(group: Optional[Any] = None) -> bool:
    """More than one process in an initialized ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1


def jit_distributed_available() -> bool:
    """More than one process in the default ``torch.distributed`` group (the
    JAX package's ``jax.process_count() > 1``)."""
    return distributed_available(None)


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


# ---------------------------------------------------------------------------
# in-program collectives (a CUDA graph or torch.compile can hold them)
# ---------------------------------------------------------------------------


def _resolve_axis(axis: Any) -> Any:
    """The functional collectives' group for ``axis``: a ``ProcessGroup``, a
    1-D ``DeviceMesh``, ``(DeviceMesh, dim)``, ``(DeviceMesh, dims)`` (the
    group spanning those dims) or a list of ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(axis, dist.ProcessGroup):
        return axis
    if isinstance(axis, DeviceMesh):
        return axis if axis.ndim == 1 else axis._flatten()
    if isinstance(axis, tuple) and len(axis) == 2 and isinstance(axis[0], DeviceMesh):
        mesh, dims = axis
        if isinstance(dims, (tuple, list)):
            if len(dims) == 1:
                return (mesh, dims[0])
            names = tuple(mesh.mesh_dim_names[d] if isinstance(d, int) else d for d in dims)
            return mesh[names]._flatten()
        return axis
    if isinstance(axis, list) and axis and all(isinstance(r, int) for r in axis):
        return axis
    raise MetricsTPUUserError(
        "An in-program sync needs a process group as its axis: a torch.distributed ProcessGroup, a "
        f"DeviceMesh, (DeviceMesh, dim or dims) or a list of ranks; got {axis!r}."
    )


def _axis_group(group: Any) -> Any:
    """The ``ProcessGroup`` behind a resolved axis."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group, DeviceMesh):
        return group.get_group()
    if isinstance(group, tuple):
        return group[0].get_group(group[1])
    return None if isinstance(group, list) else group


def _axis_size(group: Any) -> int:
    return len(group) if isinstance(group, list) else dist.get_world_size(_axis_group(group))


def check_capturable_axis(axis: Any) -> None:
    """Raise :class:`MetricsTPUUserError` unless a CUDA graph can hold the
    collectives over ``axis``: only NCCL's can be captured (gloo's run on the
    host)."""
    group = _axis_group(_resolve_axis(axis))
    backend = dist.get_backend(group)
    if backend != "nccl":
        raise MetricsTPUUserError(
            f"compiled_step(axis_name=...) on the card captures its collectives in a CUDA graph, which only "
            f"an NCCL group allows; this group's backend is {backend!r}. Sync with sync()/compute() (the host "
            "sync), or call the step inside your own program."
        )


def _program_collective(x: torch.Tensor, op: str, axis: Any) -> torch.Tensor:
    """THE in-program collective over ``axis``: ``op`` is ``"sum"``,
    ``"avg"`` (the sum over the group divided by its size, the JAX package's
    ``pmean``: an integer tensor's mean is float32), ``"max"``, ``"min"`` or
    ``"cat"`` (every rank's tensor concatenated along dim 0, the JAX
    package's tiled ``all_gather``). Waits on the result before returning
    it. Kept as its own seam, where the tests plug in a world of threads."""
    import torch.distributed._functional_collectives as funcol

    group = _resolve_axis(axis)
    if op == "cat":
        out = funcol.all_gather_tensor(x.contiguous(), 0, group)
    else:
        out = funcol.all_reduce(x, "sum" if op == "avg" else op, group)
    out = out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else funcol.wait_tensor(out)
    if op == "avg":
        out = (out if out.is_floating_point() else out.to(torch.float32)) / _axis_size(group)
    return out


def sync_leaf_in_jit(value: torch.Tensor, fx: ReduceFx, axis_name: Any) -> torch.Tensor:
    """Apply one state leaf's declared reduction over ``axis_name`` inside a
    program: sum, mean, max and min reduce, ``"cat"``/``None`` gather along
    dim 0 (a scalar as one row), a callable runs as ``fx(value, axis_name)``."""
    if fx in ("sum", "max", "min"):
        return _program_collective(value, fx, axis_name)
    if fx == "mean":
        return _program_collective(value, "avg", axis_name)
    if fx == "cat" or fx is None:
        return _program_collective(value.reshape(1) if value.ndim == 0 else value, "cat", axis_name)
    if callable(fx):
        return fx(value, axis_name)
    raise ValueError(f"Unknown dist_reduce_fx {fx!r}")


# metricslint: the empty-list skip below branches on per-rank data before
# emitting collectives. That is legal ONLY here: every rank runs the same
# program over the same schema (the docstring's contract), empty lists
# included, as SPMD guarantees the JAX package's traced program; the host
# path (host_sync_state) verifies exactly that with the health header before
# its own collectives.
def sync_in_jit(  # metricslint: disable=data-dependent-collective
    state: Dict[str, Any], reductions: Dict[str, ReduceFx], axis_name: Any, fused: bool = False
) -> Dict[str, Any]:
    """Sync a whole state dict over ``axis_name`` inside a program (or
    eagerly: the collectives are the same).

    A list state is concatenated locally first, so each state costs one
    collective; a callable ``fx`` on it runs as ``fx(concat, axis_name)``.
    A CatBuffer syncs through
    :func:`~metrics_tpu_torch.core.cat_buffer.sync_cat_buffer_in_jit`.
    ``fused=True`` concatenates the reduce leaves of each ``(dtype, fx)``
    bucket of the schema's plan (``core/plan.py``, the layout the host sync
    uses) into one collective, elementwise over the same group, so the values
    equal the per-leaf collectives'. Every rank must pass the same schema,
    empty lists included: no header checks it here.
    """
    from metrics_tpu_torch.core.cat_buffer import CatBuffer, sync_cat_buffer_in_jit

    bucket_of: Dict[str, Any] = {}
    if fused:
        from metrics_tpu_torch.parallel.bucketing import build_sync_plan

        for bkey, specs in build_sync_plan(state, reductions).reduce_buckets.items():
            for spec in specs:
                bucket_of[spec.name] = bkey
    out: Dict[str, Any] = {}
    buckets: Dict[Any, List[Any]] = {}
    for name, value in state.items():
        fx = reductions.get(name)
        if isinstance(value, CatBuffer):
            out[name] = sync_cat_buffer_in_jit(value, axis_name)
        elif isinstance(value, (list, tuple)):
            if len(value) == 0:
                out[name] = value
                continue
            value = torch.cat([v.reshape(1) if v.ndim == 0 else v for v in value])
            out[name] = [fx(value, axis_name) if callable(fx) else sync_leaf_in_jit(value, "cat", axis_name)]
        elif name in bucket_of and fx in ("sum", "mean", "max", "min"):
            buckets.setdefault(bucket_of[name], []).append((name, value))
        else:
            out[name] = sync_leaf_in_jit(value, fx, axis_name)
    for (_dtype, fx), leaves in buckets.items():
        if len(leaves) == 1:
            name, value = leaves[0]
            out[name] = sync_leaf_in_jit(value, fx, axis_name)
            continue
        reduced = sync_leaf_in_jit(torch.cat([v.reshape(-1) for _, v in leaves]), fx, axis_name)
        offset = 0
        for name, value in leaves:
            out[name] = reduced[offset:offset + value.numel()].reshape(value.shape)
            offset += value.numel()
    return out


# ---------------------------------------------------------------------------
# the host path
# ---------------------------------------------------------------------------


def _world_size(group: Optional[Any] = None) -> int:
    return dist.get_world_size(group)


def _all_gather(x: torch.Tensor, group: Optional[Any]) -> List[torch.Tensor]:
    """The bare collective: one tensor per rank, on ``x``'s device. Kept as
    its own seam, where the tests plug in a world of threads and where
    ``chip_smoke.py`` counts collectives."""
    out = [torch.empty_like(x) for _ in range(_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


def _sync_world(group: Optional[Any]) -> int:
    """The ranks a host gather over ``group`` spans: the default world's
    negotiated survivors (``resilience.effective_world``), or the group's
    size."""
    from metrics_tpu_torch.parallel.resilience import effective_world

    return effective_world() if group is None else _world_size(group)


#: What torch.distributed's backends say when a peer process is gone: gloo's
#: closed or reset TCP pair, NCCL's failed remote.
_PEER_GONE = ("connection closed by peer", "connection reset by peer", "remote process exited", "broken pipe")


def _all_gather_or_peer_lost(x: torch.Tensor, group: Optional[Any]) -> List[torch.Tensor]:
    """:func:`_all_gather`, with a backend error that says a peer process is
    gone raised as :class:`SyncTimeoutError` (the missing-rank class) and
    the channel put in probation, as a fired watchdog does. The JAX
    package's collective waits on a dead peer until its watchdog fires;
    gloo reports the peer's closed connection at once."""
    try:
        return _all_gather(x, group)
    except RuntimeError as err:
        if isinstance(err, SyncError) or not any(m in str(err).lower() for m in _PEER_GONE):
            raise
        from metrics_tpu_torch.parallel.health import mark_channel_suspect

        mark_channel_suspect()
        raise SyncTimeoutError(
            f"all_gather failed: a peer process is gone ({str(err).splitlines()[0][:200]}). Recover with "
            "Metric.sync(on_error='local'), or sync with on_missing='quorum' over the survivors."
        ) from err


def _gather(x: torch.Tensor, group: Optional[Any], timeout: Optional[float] = None) -> List[torch.Tensor]:
    """One watchdog-guarded collective. ``x`` crosses it on
    :func:`_collective_device` (the card under NCCL, the host under gloo)
    and each rank's piece comes back to ``x``'s device. A peer that is gone
    raises :class:`SyncTimeoutError` (:func:`_all_gather_or_peer_lost`).
    Once a quorum transition shrank the default world's membership, a
    gather of the default world runs over the survivors through the quorum
    transport, which takes ``x`` on its own device."""
    from metrics_tpu_torch.parallel.resilience import active_subset_transport

    device = x.device
    subset = active_subset_transport() if group is None else None
    if subset is None:
        moved = x.to(_collective_device(group))
        pieces = call_with_sync_watchdog(lambda: _all_gather_or_peer_lost(moved, group), timeout=timeout,
                                         what="all_gather")
    else:
        pieces = call_with_sync_watchdog(lambda: list(torch.as_tensor(subset(x)).unbind(0)), timeout=timeout,
                                         what="all_gather")
    return [p.to(device) for p in pieces]


def gather_all_arrays(
    result: torch.Tensor,
    group: Optional[Any] = None,
    timeout: Optional[float] = None,
    all_shapes: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """Gather one tensor from every rank; supports uneven shapes.

    Returns one tensor per rank, each trimmed back to that rank's true shape.
    ``all_shapes`` (``[world, ndim]``), when the caller knows every rank's
    shape already, saves the shape gather.
    """
    if not distributed_available(group) or _sync_world(group) == 1:
        return [result]
    if result.ndim == 0:
        return [p.reshape(()) for p in _gather(result.reshape(1), group, timeout)]
    if all_shapes is None:
        local_shape = torch.tensor(result.shape, dtype=torch.long, device=result.device)
        all_shapes = torch.stack(_gather(local_shape, group, timeout)).cpu()  # [world, ndim]
    if bool((all_shapes == all_shapes[0]).all()):
        return _gather(result, group, timeout)
    max_shape = all_shapes.amax(dim=0)
    pad = []
    for size, most in reversed(list(zip(result.shape, max_shape.tolist()))):
        pad += [0, most - size]
    padded = torch.nn.functional.pad(result, pad)
    gathered = _gather(padded, group, timeout)
    return [g[tuple(slice(0, d) for d in shape.tolist())] for g, shape in zip(gathered, all_shapes)]


def _rank_order_total(gathered: torch.Tensor) -> torch.Tensor:
    """The float sum over ranks (dim 0) adding the ranks' rows in rank
    order, half precision accumulated in float32: XLA's order, which the JAX
    package's sums have and ``torch.sum``'s vectorized reduction does not
    past a few rows. Returned in the accumulation dtype."""
    acc = torch.float32 if gathered.element_size() < 4 else gathered.dtype
    total = gathered[0].to(acc)
    for row in gathered[1:]:
        total = total + row.to(acc)
    return total


def _sum_keep_dtype(gathered: torch.Tensor) -> torch.Tensor:
    """The sum over ranks in the state's own dtype (``torch.sum`` would
    widen an int32 state to int64, as the JAX package does not); floats add
    in rank order (:func:`_rank_order_total`)."""
    if gathered.dtype == torch.bool:
        return torch.sum(gathered, dim=0)
    if gathered.is_floating_point():
        return _rank_order_total(gathered).to(gathered.dtype)
    return torch.sum(gathered, dim=0, dtype=gathered.dtype)


def _divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` correctly rounded on every device: CUDA divides by a Python
    scalar as a product with its reciprocal, an ulp away from XLA's (and the
    CPU's) quotient at times, so the divisor is a tensor."""
    return x / torch.full_like(x, n)


def _mean_over_ranks(gathered: torch.Tensor) -> torch.Tensor:
    """The mean over ranks as ``jnp.mean``: the rank-order sum divided by
    the rank count, an integer state's in float32."""
    g = gathered if gathered.is_floating_point() else gathered.to(torch.float32)
    return _divide(_rank_order_total(g), g.shape[0]).to(g.dtype)


def host_sync_leaf(
    value: Any,
    fx: ReduceFx,
    group: Optional[Any] = None,
    precheck: bool = True,
    timeout: Optional[float] = None,
) -> Any:
    """Sync one state leaf across processes.

    A list state is concatenated locally and gathered whatever its ``fx``. A
    :class:`~metrics_tpu_torch.core.cat_buffer.CatBuffer` state's valid rows
    move through the uneven-shape gather into a ``CatBuffer(world *
    capacity)`` in rank order.

    ``precheck=True`` (standalone use) first gathers the leaf's own
    participation word, so an empty list or CatBuffer makes every rank raise
    :class:`StateDivergenceError` and an overflowed CatBuffer :class:`SyncError`
    together. :func:`host_sync_state` verifies the whole state with the health
    header first and passes ``precheck=False``, which also skips the shape
    gather of a reduce leaf (its full shape is in the verified schema).
    """
    from metrics_tpu_torch.core.cat_buffer import CatBuffer

    if isinstance(value, CatBuffer):
        if not distributed_available(group):
            return value.copy()
        if precheck:
            word = torch.tensor([len(value), int(value.overflowed)])
            words = torch.stack(_gather(word, group, timeout))
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
        merged = CatBuffer(_sync_world(group) * value.capacity)
        for rows in gather_all_arrays(value.values(), group, timeout):
            merged.append(rows)
        return merged
    if isinstance(value, (list, tuple)):
        vals = [torch.cat([v.unsqueeze(0) if v.ndim == 0 else v for v in value])] if value else []
        if not distributed_available(group):
            return vals
        if precheck:
            counts = torch.stack(_gather(torch.tensor([len(vals)]), group, timeout))
            if bool((counts == 0).any()):
                raise StateDivergenceError(
                    "Cannot sync a list-state across processes: at least one process has "
                    "an empty state (no update() before sync()). All processes raised."
                )
        return gather_all_arrays(vals[0], group, timeout)
    if not distributed_available(group):
        return value
    known_shapes = None
    if not precheck and fx not in ("cat", None) and value.ndim:
        known_shapes = torch.tensor(value.shape).expand(_sync_world(group), value.ndim)
    pieces = gather_all_arrays(value, group, timeout, all_shapes=known_shapes)
    if fx == "cat" or fx is None:
        return torch.cat([p.unsqueeze(0) if p.ndim == 0 else p for p in pieces])
    gathered = torch.stack(pieces)
    if fx == "sum":
        return _sum_keep_dtype(gathered)
    if fx == "mean":
        return _mean_over_ranks(gathered)
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


def check_on_missing(on_missing: str, group: Optional[Any] = None) -> str:
    """Validate an ``on_missing`` policy: ``"raise"``, ``"quorum"`` or
    ``"local"``. Quorum negotiates over the default world, so it refuses
    another process ``group``."""
    if on_missing not in ON_MISSING_MODES:
        raise MetricsTPUUserError(f"`on_missing` must be one of {ON_MISSING_MODES}, got {on_missing!r}")
    if on_missing == "quorum" and group is not None:
        raise MetricsTPUUserError(
            "on_missing='quorum' negotiates the surviving ranks of the default torch.distributed world (its "
            "transport's subset gathers and the health word's membership columns are the default world's); a "
            "sync over another process_group cannot shrink. Use on_missing='raise' or 'local' with "
            "process_group, or drop process_group."
        )
    return on_missing


# metricslint: the channel-suspect refusal below deliberately trades schedule
# symmetry for safety AFTER a watchdog already fired: collective ordering is
# known-poisoned at that point (the timed-out rank may still sit inside its
# stale gather), so refusing to emit anything further — even though the latch
# is per-process state — is strictly safer than emitting a collective that
# could pair with the abandoned one. reset_channel_health() restores symmetry.
def host_sync_state(  # metricslint: disable=data-dependent-collective
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    group: Optional[Any] = None,
    update_count: int = 0,
    check_health: bool = True,
    strict_update_count: bool = False,
    timeout: Optional[float] = None,
    metric_name: str = "metric",
    fused: Optional[bool] = None,
    on_missing: str = "raise",
    sync_epoch: int = 0,
    stats: Optional[Dict[str, Any]] = None,
    sync_precision: Optional[str] = None,
) -> Dict[str, Any]:
    """Sync a whole metric-state dict across processes.

    With ``check_health`` (the default), every rank first contributes one
    fixed-width health word in a single gather (``parallel/health.py``):
    empty, overflowed, schema-divergent, non-finite and (strict) update-count
    skew all raise the same typed :class:`SyncError` on every rank before
    any payload moves. The payload then takes the bucketed path
    (``parallel/bucketing.py``: one collective per dtype/reduction class)
    unless ``fused`` is ``False`` (``None`` reads ``METRICS_TPU_FUSED_SYNC``),
    else the per-leaf path without its prechecks. ``check_health=False``
    takes the per-leaf path with them. Every collective runs under the
    watchdog (``timeout``, see :func:`call_with_sync_watchdog`).

    A sync of a distributed world journals ``sync.gather`` first.
    Once a watchdog fired in this process the channel is in probation
    (``parallel/resilience.py``): syncs refuse with
    :class:`SyncTimeoutError` before any collective while it cools down,
    then one sync goes through as the probe round, and its success readmits
    the channel (:func:`~metrics_tpu_torch.parallel.health.reset_channel_health`
    forces it at once).

    ``on_missing`` is the caller's policy for a missing-rank failure (a
    watchdog timeout, a divergent header): ``"raise"`` and ``"local"`` raise
    here (``Metric.sync`` degrades under ``"local"``); ``"quorum"``
    (default world only) first grows a degraded membership back when lost
    ranks answer again, and on such a failure negotiates the survivors and
    runs the health-checked gather once more over them.

    ``sync_epoch`` tags the header with the overlapped round this sync
    belongs to (0: blocking); every rank verifies it equal. The sync first
    drains the rounds this process launched (``async_sync.sync_channel``),
    so a foreground gather never pairs with a peer's background one.
    ``sync_precision`` (``"bf16"``/``"int8"``) encodes the slow hop of the
    tiered schedule (``parallel/bucketing.py``) and rides the header's
    precision column. ``stats`` is the owner's ``sync`` telemetry domain,
    which the tiered schedule's byte counters go to.
    """
    from metrics_tpu_torch.parallel import resilience
    from metrics_tpu_torch.parallel.quantize import validate_sync_precision

    check_on_missing(on_missing, group)
    sync_precision = validate_sync_precision(sync_precision)
    if not distributed_available(group):
        return {name: host_sync_leaf(value, reductions.get(name), group) for name, value in state.items()}
    if journal.ACTIVE:
        journal.record("sync.gather", label=metric_name, sync_epoch=int(sync_epoch), states=len(state), fused=fused)
    gate = resilience.channel_gate()
    if gate == "refuse":
        raise SyncTimeoutError(
            f"host sync of {metric_name} refused: an earlier collective timed out, so "
            "cross-process collective ordering can no longer be trusted (a new gather "
            "could pair with a peer's stale one). Recover with on_error='local'; the channel "
            "admits a probe round after its probation cooldown, or re-establish the process "
            "group and call metrics_tpu_torch.parallel.health.reset_channel_health()."
        )
    from metrics_tpu_torch.parallel.async_sync import sync_channel

    def attempt() -> Dict[str, Any]:
        precheck = True
        if check_health:
            from metrics_tpu_torch.parallel import bucketing

            word = torch.from_numpy(build_health_word(
                state, reductions, update_count, world=None if group is None else _world_size(group),
                sync_epoch=sync_epoch, sync_precision=sync_precision))
            words = torch.stack(_gather(word, group, timeout)).numpy()
            verify_health_words(
                words, state, reductions, strict_update_count=strict_update_count, metric_name=metric_name,
                subgroup=group is not None,
            )
            if bucketing.fused_sync_enabled() if fused is None else fused:
                return bucketing.host_sync_state_bucketed(
                    state, reductions, words=words, group=group, timeout=timeout, sync_precision=sync_precision,
                    stats=stats)
            precheck = False
        return {
            name: host_sync_leaf(value, reductions.get(name), group, precheck=precheck, timeout=timeout)
            for name, value in state.items()
        }

    with sync_channel():
        if on_missing == "quorum":
            resilience.note_sync_round()
            resilience.maybe_rejoin(metric_name=metric_name)
        try:
            synced = attempt()
        except SyncError as err:
            if not (
                on_missing == "quorum"
                and resilience.is_missing_rank_error(err)
                and resilience.negotiate_quorum(err, metric_name=metric_name) is not None
            ):
                raise
            # every survivor negotiated the same membership: the header of
            # the second attempt verifies it, its gathers run over the
            # survivors alone. Safe in a handler: negotiate_quorum already
            # re-established symmetry
            synced = attempt()  # metricslint: disable=collective-in-handler
    if gate == "probe":
        resilience.channel_probe_succeeded()
    return synced
