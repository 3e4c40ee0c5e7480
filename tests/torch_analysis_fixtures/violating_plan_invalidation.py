"""metricslint fixture (torch twin, line for line): asymmetric-schedule-decision —
execution-plan invalidations that would desynchronize the fleet one plan generation
at a time.

A ``plan_invalidate`` bumps the owner's binding generation, which re-
captures fused programs and re-keys the bucketed sync layout: a rank that invalidates
while its peers do not soon dispatches a differently-shaped collective
schedule. The CI gate asserts the CLI exits NONZERO on this file. The call
names mirror ``core/plan.py``'s conventions (that is what the schedule pass
keys on); the stubs keep the module import-safe.
"""
import torch.distributed as dist


def plan_invalidate(owner, reason="state-mutated", schema_changed=False, groups_stale=False):
    return None  # stand-in


def channel_is_suspect():  # stand-in per-process latch
    return False


def rank_dependent_invalidation(owner):
    """finding: asymmetric-schedule-decision — only rank 0 drops its plan, so
    rank 0 retraces and re-buckets while its peers keep the old layout."""
    if dist.get_rank() == 0:
        plan_invalidate(owner, "rank0-refresh", schema_changed=True)


def data_dependent_invalidation(owner, state):
    """finding: asymmetric-schedule-decision — ranks whose local state grew
    large invalidate their plan while their peers keep the cached one."""
    if len(state) > 1000:
        plan_invalidate(owner, "big-state", groups_stale=True)


def data_derived_reason(owner, value):
    """finding: asymmetric-schedule-decision — the committed reason string is
    computed from per-rank data, so rank telemetries (and any policy keyed on
    the reason) diverge with the data."""
    plan_invalidate(owner, f"threshold-{int(value > 0.5)}")


def latch_governed_invalidation(owner):
    """finding: asymmetric-schedule-decision — the per-process suspect latch
    differs across ranks; an invalidation gated on it diverges with it."""
    if channel_is_suspect():
        plan_invalidate(owner, "suspect-channel", groups_stale=True)


def clean_symmetric_invalidation(owner, world):
    """No findings: the invalidation derives from symmetric inputs (world
    size is a collective-round fact every rank observes identically)."""
    if world > 1:
        plan_invalidate(owner, "membership-changed", schema_changed=True)
