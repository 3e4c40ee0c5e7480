"""The tier topology of the two-level host-sync schedule.

Counterpart of ``metrics_tpu/parallel/tiering.py``. A fleet of H100 nodes is
not flat: the ranks of one node talk over NVLink, nodes over the network.
The tiered schedule (``parallel/bucketing.py``) makes the slow hop carry the
fewest participants and bytes; this module owns its topology:

- **Configuration.** A tier map gives every rank a tier id: the
  ``METRICS_TPU_TIER_SIZE`` env knob (ranks ``[k*size, (k+1)*size)`` share
  tier ``k``: a size of 8 maps one 8-card node to one tier) or the explicit
  :func:`set_tier_map` (an int size, or a ``rank -> tier`` callable), which
  wins over the knob. No map: the flat world, and a sync is the untiered one
  with no extra collective.
- **Negotiation.** The topology is a pure function of the negotiated live
  set (``parallel/resilience.py``) and the map, so every rank derives the
  same :class:`TierTopology` with no collective, in the same membership
  epoch as a quorum shrink too. The health word (protocol v5) carries each
  rank's tier id; :func:`expected_tier_column` is what the verifier holds
  the gathered column to, so an asymmetric map raises
  ``StateDivergenceError`` on every rank before any payload moves.
- **Transport.** Tier hops are subset collectives over the quorum
  transport's interface, ``subset_allgather(x, ranks)``:
  :func:`active_tier_transport` takes an installed tier transport, else the
  quorum transport. The package ships neither; a map configured with no
  transport warns once and keeps the flat path.

The tiers are ranks of the default ``torch.distributed`` world; a sync over
another process group keeps the flat schedule (``parallel/sync.py``).
"""
import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = [
    "TIER_SIZE_ENV",
    "TierTopology",
    "active_tier_transport",
    "active_topology",
    "expected_tier_column",
    "my_tier_id",
    "reset_tiering",
    "set_tier_map",
    "set_tier_transport",
    "tier_of_rank",
    "tier_topology",
    "tiering_configured",
]

#: Env knob: an int tier size; ranks ``[k*size, (k+1)*size)`` share tier ``k``.
TIER_SIZE_ENV = "METRICS_TPU_TIER_SIZE"

_LOCK = threading.Lock()
_TIER_MAP: Optional[Callable[[int], int]] = None
_TIER_MAP_TOKEN: Any = None
_TIER_TRANSPORT: Optional[Any] = None
_TOPOLOGY_CACHE: Dict[Any, "TierTopology"] = {}


def _current_rank() -> int:
    """This process's rank in the default world (0 without one): a seam that
    a world of thread ranks patches to the calling thread's rank."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def set_tier_map(tier_map: Any) -> None:
    """Install (or clear, with ``None``) the explicit tier map: an int tier
    size or a ``rank -> tier id`` callable. It wins over
    :data:`TIER_SIZE_ENV` and must be the same on every rank (the health
    word's tier column checks that)."""
    global _TIER_MAP, _TIER_MAP_TOKEN
    with _LOCK:
        if tier_map is None:
            _TIER_MAP, _TIER_MAP_TOKEN = None, None
        elif callable(tier_map):
            _TIER_MAP, _TIER_MAP_TOKEN = tier_map, ("fn", id(tier_map))
        else:
            size = int(tier_map)
            if size <= 0:
                raise MetricsTPUUserError(f"tier size must be a positive int, got {tier_map!r}")
            _TIER_MAP = lambda rank, _s=size: rank // _s  # noqa: E731
            _TIER_MAP_TOKEN = ("size", size)
        _TOPOLOGY_CACHE.clear()


def set_tier_transport(transport: Optional[Any]) -> None:
    """Install (or clear) the transport the tier hops run over (the quorum
    transport's ``subset_allgather(x, ranks)`` interface)."""
    global _TIER_TRANSPORT
    with _LOCK:
        _TIER_TRANSPORT = transport


def reset_tiering() -> None:
    """Clear the map, the transport and the topology cache."""
    global _TIER_MAP, _TIER_MAP_TOKEN, _TIER_TRANSPORT
    with _LOCK:
        _TIER_MAP, _TIER_MAP_TOKEN, _TIER_TRANSPORT = None, None, None
        _TOPOLOGY_CACHE.clear()


def _configured_map() -> Tuple[Optional[Callable[[int], int]], Any]:
    """``(tier_of, cache token)``: the explicit map, else the env size, else
    ``(None, None)`` (the flat world)."""
    with _LOCK:
        if _TIER_MAP is not None:
            return _TIER_MAP, _TIER_MAP_TOKEN
    raw = os.environ.get(TIER_SIZE_ENV, "").strip()
    if not raw:
        return None, None
    try:
        size = int(raw)
    except ValueError:
        from metrics_tpu_torch.observability.diagnostics import warn_once

        warn_once(
            "tier-size-invalid",
            f"{TIER_SIZE_ENV}={raw!r} is not an int: tiered sync disabled, the flat world gather stays.",
        )
        return None, None
    if size <= 0:
        return None, None
    return (lambda rank, _s=size: rank // _s), ("size", size)


def tiering_configured() -> bool:
    """Is a tier map (explicit or env) configured on this rank?"""
    return _configured_map()[0] is not None


def tier_of_rank(rank: int) -> int:
    """``rank``'s tier id under the configured map; -1 without one."""
    fn, _ = _configured_map()
    return -1 if fn is None else int(fn(int(rank)))


def my_tier_id() -> int:
    """This rank's tier id (-1 without a map): its health-word column."""
    return tier_of_rank(_current_rank())


class TierTopology:
    """The two-level layout over one live-rank set, the same on every rank:

    - ``live``: the sorted live ranks (the gather's row order);
    - ``tiers``: tier id -> sorted member ranks (tier ids sorted);
    - ``leaders``: one leader (the min rank) a tier, in tier order: the
      inter-tier exchange's participants;
    - ``assembly``: for each live rank, its row ``tier_pos * max_tier +
      member_pos`` in the concatenated padded tier blocks, so every rank
      rebuilds the flat gather's ``[world, n]`` matrix exactly;
    - the executing rank's view: ``my_tier_ranks``, ``is_leader``,
      ``tier_pos``.

    ``degenerate`` (one tier, or one rank a tier) keeps the flat path.
    """

    __slots__ = (
        "key",
        "live",
        "tiers",
        "leaders",
        "max_tier",
        "assembly",
        "rank",
        "my_tier",
        "my_tier_ranks",
        "is_leader",
        "leader_pos",
        "tier_pos",
        "expected_tiers",
    )

    def __init__(self, live: Tuple[int, ...], tier_of: Callable[[int], int], rank: int, key: Any) -> None:
        self.key = key
        self.live = tuple(sorted(int(r) for r in live))
        members: Dict[int, list] = {}
        for r in self.live:
            members.setdefault(int(tier_of(r)), []).append(r)
        self.tiers = {tid: tuple(members[tid]) for tid in sorted(members)}
        self.leaders = tuple(ranks[0] for ranks in self.tiers.values())
        self.max_tier = max(len(ranks) for ranks in self.tiers.values())
        tier_order = {tid: i for i, tid in enumerate(self.tiers)}
        self.expected_tiers = np.asarray([tier_of(r) for r in self.live], np.int32)
        pos: Dict[int, int] = {}
        for tid, ranks in self.tiers.items():
            for j, r in enumerate(ranks):
                pos[r] = tier_order[tid] * self.max_tier + j
        self.assembly = np.asarray([pos[r] for r in self.live], np.int64)
        self.rank = int(rank)
        my_tid = int(tier_of(self.rank)) if self.rank in pos else None
        self.my_tier = my_tid
        self.my_tier_ranks = self.tiers.get(my_tid, ())
        self.is_leader = bool(self.my_tier_ranks) and self.my_tier_ranks[0] == self.rank
        self.leader_pos = 0  # the leader is the min rank: row 0 of its tier block
        self.tier_pos = tier_order.get(my_tid, -1)

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def degenerate(self) -> bool:
        """One tier, or one rank a tier: the flat gather is already best."""
        return self.n_tiers <= 1 or self.max_tier <= 1

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TierTopology(n_tiers={self.n_tiers}, live={len(self.live)}, rank={self.rank}, "
                f"tier={self.my_tier}, leader={self.is_leader})")


def tier_topology(live: Any, rank: int, tier_of: Optional[Callable[[int], int]] = None) -> TierTopology:
    """The (memoized) :class:`TierTopology` of one live set, keyed on
    ``(live, map token, rank)``: a quorum shrink changes ``live`` and so
    derives the new topology in the same epoch, with no collective."""
    if tier_of is None:
        tier_of, token = _configured_map()
        if tier_of is None:
            raise MetricsTPUUserError(f"tier_topology: no tier map configured (set_tier_map or {TIER_SIZE_ENV})")
    else:
        token = ("fn", id(tier_of))
    live_t = tuple(sorted(int(r) for r in live))
    key = (live_t, token, int(rank))
    with _LOCK:
        topo = _TOPOLOGY_CACHE.get(key)
        if topo is None:
            topo = TierTopology(live_t, tier_of, int(rank), key)
            if len(_TOPOLOGY_CACHE) > 64:  # membership changes are rare
                _TOPOLOGY_CACHE.clear()
            _TOPOLOGY_CACHE[key] = topo
        return topo


def expected_tier_column(world: int) -> Optional[np.ndarray]:
    """The tier column this rank expects every live rank to report, in the
    gathered words' row order (sorted live ranks); ``None`` without a map
    (every rank must then report -1). When the gathered world disagrees with
    the local live view, the map over ``range(world)`` (the membership check
    fires first anyway)."""
    fn, _ = _configured_map()
    if fn is None:
        return None
    from metrics_tpu_torch.parallel.resilience import live_ranks

    live = tuple(sorted(live_ranks()))
    if len(live) != world:
        live = tuple(range(world))
    return np.asarray([int(fn(r)) for r in live], np.int32)


def active_tier_transport() -> Optional[Any]:
    """The transport of the tier hops: the installed tier transport, else
    the quorum transport, else ``None`` (tiered sync stays off)."""
    with _LOCK:
        if _TIER_TRANSPORT is not None:
            return _TIER_TRANSPORT
    from metrics_tpu_torch.parallel import resilience

    return resilience._TRANSPORT


def active_topology() -> Optional[TierTopology]:
    """The topology the next bucketed sync schedules over, or ``None`` for
    the flat path: no map, no transport (warned once), or a degenerate
    layout."""
    fn, _token = _configured_map()
    if fn is None:
        return None
    if active_tier_transport() is None:
        from metrics_tpu_torch.observability.diagnostics import warn_once

        warn_once(
            "tier-no-transport",
            "a tier map is configured but no subset-collective transport is installed "
            "(tiering.set_tier_transport / resilience.set_quorum_transport): the two-level schedule "
            "cannot issue tier-local collectives, so syncs keep the flat world gather.",
        )
        return None
    from metrics_tpu_torch.parallel.resilience import live_ranks

    topo = tier_topology(live_ranks(), _current_rank(), None)
    return None if topo.degenerate else topo
