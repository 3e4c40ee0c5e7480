"""The per-owner plan binding and the one invalidation path.

Counterpart of the part of ``metrics_tpu/core/plan.py`` that the compiled
hot path (``core/compiled.py``) stands on:

- :class:`PlanBinding`: the compiled-program namespace of one ``Metric`` or
  ``MetricCollection`` (the programs, keyed by call signature, and the set
  of probed keys) and the ``generation`` every invalidation bumps;
- :func:`binding` / :func:`peek_binding`;
- :func:`plan_invalidate`, :func:`mark_state_mutated` and
  :func:`mark_donation_ready`: every state mutation that revokes the compiled
  path's ownership of a metric's state buffers goes through here, and the
  ``plan`` domain of the telemetry registry counts it by reason.

On the card, "donation ready" means the metric's state tensors are the
static buffers its CUDA graphs write (``core/compiled.py``): the next replay
may run on them as they are. A mutation (a restore, a load, an eager update)
or a read that hands a state tensor out revokes it, and the next dispatch
copies the state in again.

Not ported yet: the ``ExecutionPlan`` store's takeover of the bucket layout
and ``compiled_step`` with ``fused_step_refusal`` (ROADMAP A9.3),
``TierSchedule`` (A10.3) and ``next_sync_epoch`` (A10.1).
"""
from typing import Any, Dict, Optional

from metrics_tpu_torch.observability import journal
from metrics_tpu_torch.observability.registry import registry_of

__all__ = [
    "PlanBinding",
    "binding",
    "mark_donation_ready",
    "mark_state_mutated",
    "peek_binding",
    "plan_invalidate",
]


class PlanBinding:
    """Per-instance plan state: the compiled-program namespace (``programs``,
    ``probed``) and the ``generation`` bumped by every
    :func:`plan_invalidate`. Never copied or pickled: programs hold the
    original owner's buffers."""

    __slots__ = ("label", "generation", "programs", "probed")

    def __init__(self, label: str = "metric") -> None:
        self.label = label
        self.generation = 0
        self.programs: Dict[Any, Any] = {}
        self.probed: set = set()

    def __deepcopy__(self, memo: dict) -> "PlanBinding":
        return PlanBinding(self.label)

    def __reduce__(self):
        return (PlanBinding, (self.label,))


def binding(owner: Any) -> PlanBinding:
    """The owner's :class:`PlanBinding` (created on first use, with the
    ``plan`` telemetry domain its invalidations count into)."""
    b = owner.__dict__.get("_plan_binding")
    if b is None:
        b = PlanBinding(type(owner).__name__)
        object.__setattr__(owner, "_plan_binding", b)
        registry_of(owner).domain("plan")
    return b


def peek_binding(owner: Any) -> Optional[PlanBinding]:
    """The owner's binding if the plan machinery ever engaged, else ``None``."""
    return owner.__dict__.get("_plan_binding")


def plan_invalidate(owner: Any, reason: str = "state-mutated", schema_changed: bool = False) -> None:
    """THE invalidation entry: bumps the binding's generation and counts the
    invalidation (by reason) in the owner's ``plan`` telemetry domain. A
    schema change also marks a collection's compute groups stale. One dict
    lookup when no plan machinery ever engaged."""
    d = owner.__dict__
    if schema_changed and "_groups_stale" in d:
        object.__setattr__(owner, "_groups_stale", True)
    b = d.get("_plan_binding")
    if b is None:
        return
    b.generation += 1
    dom = registry_of(owner).domain("plan")
    dom["invalidations"] += 1
    reasons = dom.setdefault("invalidate_reasons", {})
    reasons[reason] = reasons.get(reason, 0) + 1
    if journal.ACTIVE:
        journal.record(
            "plan.invalidate", label=b.label, reason=reason, schema_changed=schema_changed, generation=b.generation
        )


def mark_state_mutated(owner: Any, reason: str = "state-mutated", schema_changed: bool = False) -> None:
    """Clear the donation latch and notify the plan layer. The notification
    fires only on an actual ownership transition (the latch was set) or a
    schema change: re-clearing a clear latch is the eager path's common case
    and stays two dict operations."""
    d = owner.__dict__
    owned = d.get("_donation_ready", False)
    if owned:
        object.__setattr__(owner, "_donation_ready", False)
    if owned or schema_changed:
        plan_invalidate(owner, reason, schema_changed=schema_changed)


def mark_donation_ready(owner: Any) -> None:
    """The inverse transition: a compiled dispatch left the owner's state on
    the buffers its programs write. Bookkeeping only, never an invalidation."""
    object.__setattr__(owner, "_donation_ready", True)
