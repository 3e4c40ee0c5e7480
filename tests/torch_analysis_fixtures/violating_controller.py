"""metricslint fixture (torch twin, line for line): asymmetric-schedule-decision
violations — controller decisions that would legally desynchronize the fleet
one config knob at a time.

The CI gate asserts the CLI exits NONZERO on this file. The call names
mirror ``parallel/resilience.py``'s conventions (that is what the schedule
pass keys on); the stubs keep the module import-safe.
"""
import torch.distributed as dist


def commit_schedule_decision(kind, value, *, epoch=0, reason=""):  # stand-in
    return value


def channel_is_suspect():  # stand-in per-process latch
    return False


def rank_dependent_cadence():
    """finding: asymmetric-schedule-decision — only rank 0 halves the sync
    cadence, so rank 0 soon emits half the collectives its peers do."""
    if dist.get_rank() == 0:
        commit_schedule_decision("sync_cadence_multiplier", 2, epoch=1, reason="rank0")


def rank_derived_timeout():
    """finding: asymmetric-schedule-decision — the committed timeout value
    itself is computed from the rank, so watchdogs fire at different times
    and ranks abandon gathers their peers are still waiting in."""
    timeout = 5.0 * (1 + dist.get_rank())
    commit_schedule_decision("watchdog_timeout_s", timeout, epoch=1, reason="per-rank")


def data_dependent_policy(state):
    """finding: asymmetric-schedule-decision — ranks whose local state grew
    large switch staleness policy while their peers keep the old one."""
    if len(state) > 1000:
        commit_schedule_decision("staleness_policy", "merge", epoch=2, reason="big state")


def latch_governed_decision():
    """finding: asymmetric-schedule-decision — the per-process suspect latch
    differs across ranks; a decision gated on it diverges with it."""
    if channel_is_suspect():
        commit_schedule_decision("sync_cadence_multiplier", 4, epoch=3, reason="suspect")


def clean_symmetric_decision(world, ewma_gather_s):
    """No findings: the decision derives from symmetric inputs (world size,
    an EWMA of journal-observed gather times — themselves collective-round
    facts every rank observes identically)."""
    if world > 1:
        commit_schedule_decision(
            "watchdog_timeout_s", max(5.0, 8.0 * ewma_gather_s), epoch=4, reason="ewma"
        )
