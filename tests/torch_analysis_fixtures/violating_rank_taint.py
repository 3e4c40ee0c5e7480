"""metricslint fixture (torch only): the schedule pass's torch vocabulary.

Every collective the pass knows (``torch.distributed``, the functional
collectives, the port's two seams) fires under a rank guard; every rank
source (``get_rank``, the port's rank helpers, the ``RANK``/``LOCAL_RANK``
environment variables) taints; each symmetric reading the vocabulary adds
(world size, tensor schema, the state dict's key set) sits beside the
asymmetric form that still fires. The stubs keep the module import-safe.

The CI gate asserts the CLI exits NONZERO on this file.
"""
import os

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol


def _gather(x, group=None, timeout=None):  # stand-in seam (parallel/sync.py)
    return [x]


def _program_collective(x, op, axis):  # stand-in seam (parallel/sync.py)
    return x


def _rank():  # stand-in rank helper (utils/prints.py)
    return 0


def _current_rank():  # stand-in rank helper (parallel/tiering.py)
    return 0


def _default_rank():  # stand-in rank helper (observability/journal.py)
    return 0


def _default_coordinates(rank, world):  # stand-in (core/checkpoint.py)
    return 0, 1


def _sync_world(group):  # stand-in world size (parallel/sync.py)
    return 1


def every_collective_rank_gated(x, group, out, pieces):
    """finding: rank-dependent-collective, once for each collective below."""
    if dist.get_rank() == 0:
        dist.all_gather(pieces, x, group=group)
        dist.all_gather_into_tensor(out, x, group=group)
        dist.all_reduce(x, group=group)
        dist.broadcast(x, src=0, group=group)
        dist.reduce_scatter_tensor(out, x, group=group)
        dist.all_to_all_single(out, x, group=group)
        dist.barrier(group=group)
        dist.all_gather_object(pieces, x, group=group)
        dist.broadcast_object_list(pieces, src=0, group=group)
        funcol.all_gather_tensor(x, 0, group)
        funcol.wait_tensor(funcol.all_reduce(x, "sum", group))
        _gather(x, group)
        _program_collective(x, "sum", group)


def rank_helper_gated(x):
    """finding: rank-dependent-collective, once for each rank source."""
    if _rank() == 0:
        _gather(x)
    if _current_rank() == 1:
        _gather(x)
    if _default_rank() > 0:
        _gather(x)
    rank, world = _default_coordinates(None, None)
    if rank == 0:
        _gather(x)


def rank_env_gated(x):
    """finding: rank-dependent-collective — under torchrun these variables
    ARE the rank."""
    if os.environ["RANK"] == "0":
        _gather(x)
    if int(os.environ.get("LOCAL_RANK", "0")) == 0:
        _gather(x)
    if os.getenv("RANK") == "0":
        _gather(x)


def symmetric_env_knob(x):
    """no finding: any other environment knob is config, alike everywhere."""
    if os.environ.get("METRICS_TPU_FUSED_SYNC", "1") == "1":
        _gather(x)


def world_size_guard(x, group):
    """world size is symmetric; combined with the rank it is not."""
    if dist.get_world_size() > 1 and _sync_world(group) > 1:
        _gather(x)  # clean
    if dist.get_world_size() > 1 and dist.get_rank() == 0:
        _gather(x)  # finding: rank-dependent-collective


def schema_guards(value, x):
    """tensor schema (methods and attributes) is header-verified; the
    values of the same tensor are per-rank data."""
    if value.numel() == 0 or value.dim() == 0 or value.element_size() < 4:
        _gather(x)  # clean
    if value.is_floating_point() and value.is_cuda and value.device.type == "cuda":
        _gather(x)  # clean
    if value.sum() == 0:
        _gather(x)  # finding: data-dependent-collective


def key_set_guards(state, values, x):
    """the state dict's key set is schema; its size, other sets and
    iteration over a set are not."""
    if set(state) >= {"total"} and "total" in state.keys():
        _gather(x)  # clean
    if len(state) > 0:
        _gather(x)  # finding: data-dependent-collective
    if set(values) >= {1}:
        _gather(x)  # finding: data-dependent-collective
    for name in set(state):
        _gather(state[name])  # finding: nondeterministic-collective-order (+ data)
