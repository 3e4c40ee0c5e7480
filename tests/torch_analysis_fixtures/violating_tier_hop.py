"""metricslint fixture (torch twin, line for line): ad-hoc rank-gated tier hops.

The tiered sync schedule (``parallel/tiering.py`` + ``parallel/bucketing.py``)
is legal because its topology is NEGOTIATED: a pure function of the agreed
live set and a config-identical tier map, re-verified by the health word's
tier column before any payload collective — so the schedule pass treats the
tiering readers as taint-washing symmetric calls. This fixture is the
anti-pattern: hand-rolled "hierarchical" hops gated directly on
``get_rank()`` arithmetic, which no header ever verifies. The CI gate
asserts the CLI exits NONZERO on this file.
"""
import torch
import torch.distributed as dist


def _gather(x, group=None, timeout=None):  # stand-in collective
    return [torch.as_tensor(x)]


def adhoc_leader_exchange(x, tier_size):
    """finding: rank-dependent-collective — only self-appointed 'leaders'
    (a raw get_rank modulus, never negotiated or header-verified)
    emit the inter-tier gather."""
    if dist.get_rank() % tier_size == 0:
        return _gather(x)
    return x


def adhoc_tier_branch(x, tier_size):
    """finding: rank-dependent-collective — ranks in tier 0 run a different
    collective sequence than every other tier."""
    tier = dist.get_rank() // tier_size
    if tier == 0:
        return _gather(_gather(x))
    return _gather(x)
