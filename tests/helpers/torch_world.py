"""A world of ranks on threads for the PyTorch port's sync.

The port's counterpart of :class:`tests.helpers.fake_world.LockstepWorld`:
``fn(rank)`` runs on one thread per rank, and every collective of
``metrics_tpu_torch.parallel.sync`` becomes a rendezvous of its group's
ranks that hands each of them what every one contributed. The real sync code runs on each
rank, in one process, with no process group.

Install with ``world.install(monkeypatch)``. It patches the port's two
collective seams, ``_all_gather`` (the host sync) and
``_program_collective`` (the in-program sync of ``sync_in_jit``), reports a
distributed world with collectives on the host, gives each rank a background
lane of its own for the overlapped rounds (``executor_for_current_rank``,
whose worker adopts the rank's identity, as ``fake_world.py`` does), and
turns the watchdog off (``METRICS_TPU_SYNC_TIMEOUT_S=0``), since its worker
thread would not carry the rank's identity. Call ``shutdown_executors()``
when done.

The world is also a tier transport (``subset_allgather``: a rendezvous of a
subset of ranks, apart from the group collectives), and ``install`` points
the resilience and tiering layers' rank seams (``resilience._current_domain``,
``tiering._current_rank``) at the calling thread's rank.
:class:`TorchFleetWorld` is the port's counterpart of
``fake_world.FleetWorld``: a fault-injecting fleet (dead ranks, transient
drops, hazard preemption, a per-tier latency model) that is the quorum
transport itself (``probe``, ``negotiate_allgather``, ``subset_allgather``).

A 2-D world: ``TorchLockstepWorld(mesh=(("dp", 4), ("mp", 2)))`` lays the
ranks out row-major, as the JAX tests' ``devices.reshape(DP, MP)``;
``world.axis("dp")`` is the group handle of the current rank's "dp" slice
(the ranks that share its "mp" coordinate), ``world.axis("dp", "mp")`` the
whole world. A handle is what the port's ``process_group`` and
``axis_name`` take here; each group's collectives rendezvous on their own.
"""
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

import metrics_tpu_torch.parallel.async_sync as async_mod
import metrics_tpu_torch.parallel.resilience as resilience_mod
import metrics_tpu_torch.parallel.sync as sync_mod
import metrics_tpu_torch.parallel.tiering as tiering_mod
from metrics_tpu_torch.parallel.async_sync import SerialExecutor
from metrics_tpu_torch.utils.exceptions import SyncTimeoutError


class WorldAxis:
    """A group handle: the named mesh dims it spans. The participants are
    resolved per calling rank (its slice of the other dims)."""

    __slots__ = ("dims",)

    def __init__(self, dims: Sequence[str]) -> None:
        self.dims = tuple(dims)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"WorldAxis{self.dims}"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, WorldAxis) and other.dims == self.dims

    def __hash__(self) -> int:
        return hash(("WorldAxis", self.dims))


class TorchLockstepWorld:
    """``calls`` counts collective rounds (one per rendezvous, not per
    rank); ``bytes`` the bytes all ranks put into them. A rank that raises
    aborts the rendezvous, so its peers fail fast instead of waiting."""

    def __init__(self, world: int = 2, mesh: Optional[Sequence[Tuple[str, int]]] = None) -> None:
        self.mesh = tuple(mesh) if mesh is not None else (("world", world),)
        size = 1
        for _name, n in self.mesh:
            size *= n
        self.world = size if mesh is not None else world
        self.calls = 0
        self.bytes = 0
        self._rank = threading.local()
        self._cv = threading.Condition()
        self._rounds: Dict[Tuple[int, FrozenSet[int]], int] = {}
        self._entries: Dict[Tuple[FrozenSet[int], int], Dict[str, Any]] = {}
        self._aborted = False
        self._executors: Dict[int, SerialExecutor] = {}
        self._executors_lock = threading.Lock()

    # -- installation ------------------------------------------------------

    def install(self, monkeypatch: Any) -> "TorchLockstepWorld":
        monkeypatch.setattr(sync_mod, "_all_gather", self.all_gather)
        monkeypatch.setattr(sync_mod, "_program_collective", self.program_collective)
        monkeypatch.setattr(sync_mod, "_world_size", self.world_size)
        monkeypatch.setattr(sync_mod, "distributed_available", lambda group=None: True)
        monkeypatch.setattr(sync_mod, "_collective_device", lambda group=None: torch.device("cpu"))
        monkeypatch.setattr(async_mod, "_get_executor", self.executor_for_current_rank)
        monkeypatch.setattr(async_mod, "_current_domain", self.rank_domain)
        monkeypatch.setattr(resilience_mod, "_current_domain", self.rank_domain)
        monkeypatch.setattr(tiering_mod, "_current_rank", lambda: self.rank_domain() or 0)
        monkeypatch.setenv("METRICS_TPU_SYNC_TIMEOUT_S", "0")
        return self

    # -- the mesh ----------------------------------------------------------

    def axis(self, *dims: str) -> WorldAxis:
        names = [n for n, _ in self.mesh]
        assert all(d in names for d in dims), f"{dims} not in the mesh {names}"
        return WorldAxis(dims)

    def coords(self, rank: int) -> Dict[str, int]:
        out, rest = {}, rank
        for name, n in reversed(self.mesh):
            out[name] = rest % n
            rest //= n
        return out

    def participants(self, group: Any, rank: Optional[int] = None) -> FrozenSet[int]:
        """The ranks of ``group`` (``None``: the world; a :class:`WorldAxis`;
        a list of ranks) that the calling rank belongs to."""
        rank = self._rank.value if rank is None else rank
        if group is None:
            return frozenset(range(self.world))
        if isinstance(group, WorldAxis):
            me = self.coords(rank)
            fixed = [n for n, _ in self.mesh if n not in group.dims]
            return frozenset(r for r in range(self.world) if all(self.coords(r)[n] == me[n] for n in fixed))
        ranks = frozenset(int(r) for r in group)
        assert rank in ranks, f"rank {rank} is not in the group {sorted(ranks)}"
        return ranks

    def world_size(self, group: Any = None) -> int:
        return len(self.participants(group))

    # -- collectives -------------------------------------------------------

    def all_gather(self, x: torch.Tensor, group: Any = None, timeout_s: float = 60.0) -> List[torch.Tensor]:
        """Every participant's ``x``, in rank order: a rendezvous of the
        group's ranks only, so rounds of different groups run at once;
        rounds of one group are ordered per rank."""
        return self._rendezvous(x, self.participants(group), "group", timeout_s)

    def subset_allgather(self, x: torch.Tensor, ranks: Any, timeout_s: float = 60.0) -> torch.Tensor:
        """The tier-transport seam: the stacked ``x`` of a subset of ranks
        (the caller among them), a rendezvous of its own."""
        ranks = frozenset(int(r) for r in ranks)
        assert self._rank.value in ranks, f"rank {self._rank.value} is not in {sorted(ranks)}"
        return torch.stack(self._rendezvous(x, ranks, "subset", timeout_s))

    def _rendezvous(self, x: torch.Tensor, ranks: FrozenSet[int], tag: str, timeout_s: float) -> List[torch.Tensor]:
        rank = self._rank.value
        with self._cv:
            idx = self._rounds.get((rank, tag, ranks), 0)
            self._rounds[(rank, tag, ranks)] = idx + 1
            entry = self._entries.setdefault((tag, ranks, idx), {"slots": {}, "read": 0})
            entry["slots"][rank] = x.detach().clone()
            if len(entry["slots"]) == len(ranks):
                self.calls += 1
                self.bytes += sum(s.numel() * s.element_size() for s in entry["slots"].values())
                self._cv.notify_all()
            elif not self._cv.wait_for(lambda: len(entry["slots"]) == len(ranks) or self._aborted, timeout_s):
                raise threading.BrokenBarrierError(f"rank {rank}: group {sorted(ranks)} never met")
            if len(entry["slots"]) < len(ranks):
                raise threading.BrokenBarrierError(f"rank {rank}: a peer of group {sorted(ranks)} raised")
            out = [entry["slots"][r].clone() for r in sorted(ranks)]
            entry["read"] += 1
            if entry["read"] == len(ranks):
                del self._entries[(tag, ranks, idx)]
        return out

    def program_collective(self, x: torch.Tensor, op: str, axis: Any) -> torch.Tensor:
        """The in-program seam over this world's group ``axis``, with the
        functional collectives' semantics: ``"cat"`` concatenates along dim
        0, ``"sum"`` keeps the dtype, ``"avg"`` is the sum over the group
        divided by its size (float32 for an integer tensor)."""
        pieces = self.all_gather(x, axis)
        if op == "cat":
            return torch.cat(pieces)
        stacked = torch.stack(pieces)
        if op in ("sum", "avg"):
            out = sync_mod._sum_keep_dtype(stacked)
            if op == "avg":
                out = (out if out.is_floating_point() else out.to(torch.float32)) / len(pieces)
            return out
        return torch.amax(stacked, dim=0) if op == "max" else torch.amin(stacked, dim=0)

    # -- the overlapped rounds' lanes ---------------------------------------

    def executor_for_current_rank(self) -> SerialExecutor:
        """The calling rank's own background lane, whose worker thread
        adopts the rank's identity (``async_sync._get_executor``'s seam)."""
        rank = self._rank.value
        with self._executors_lock:
            ex = self._executors.get(rank)
            if ex is None:

                def _adopt_rank(r: int = rank) -> None:
                    self._rank.value = r

                ex = SerialExecutor(f"torch-lockstep-async-rank{rank}", initializer=_adopt_rank)
                self._executors[rank] = ex
            return ex

    def rank_domain(self) -> Any:
        """This thread's rank (``async_sync._current_domain``'s seam): a
        rank drains only the rounds it launched, as a process would."""
        return getattr(self._rank, "value", None)

    def shutdown_executors(self) -> None:
        with self._executors_lock:
            for ex in self._executors.values():
                ex.shutdown(wait=False)
            self._executors.clear()

    # -- running ranks ------------------------------------------------------

    def _abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._cv.notify_all()

    def run(self, fn: Callable[[int], Any], timeout: float = 60.0) -> List[Any]:
        """``fn(rank)`` on every rank; the results in rank order. The first
        rank's exception is raised again here."""
        results: List[Any] = [None] * self.world
        errors: List[Optional[BaseException]] = [None] * self.world

        def body(rank: int) -> None:
            self._rank.value = rank
            try:
                results[rank] = fn(rank)
            except BaseException as err:  # noqa: BLE001 - raised again below
                errors[rank] = err
                self._abort()

        threads = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if any(t.is_alive() for t in threads):
            self._abort()
            raise RuntimeError("TorchLockstepWorld deadlocked: a rank never reached the rendezvous")
        with self._cv:
            self._aborted = False
            self._rounds.clear()
            self._entries.clear()
        for err in errors:
            if err is not None:
                raise err
        return results

    def run_catching(self, fn: Callable[[int], Any], timeout: float = 60.0) -> List[Any]:
        """``fn(rank)`` on every rank; each rank's result, or the class of the
        exception it raised."""

        def catching(rank: int) -> Any:
            try:
                return fn(rank)
            except Exception as err:  # noqa: BLE001 - the class is the result
                # a peer still waiting in a collective fails fast instead
                self._abort()
                return type(err)

        return self.run(catching, timeout)


def state_bits(state: Dict[str, Any]) -> Dict[str, Any]:
    """Each state's bits, comparable across the two packages: a tensor or
    array as ``(dtype name, shape, bytes)``, a list as its entries' bytes, a
    CatBuffer as its capacity, count and valid rows' bytes."""

    import ml_dtypes

    def _np(v: Any) -> np.ndarray:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if v.dtype == torch.bfloat16 else v.numpy()
        return np.asarray(v)

    out = {}
    for name in sorted(state):
        v = state[name]
        if hasattr(v, "capacity") and hasattr(v, "values"):
            out[name] = (v.capacity, int(_np(v.count)), _np(v.values()).tobytes())
        elif isinstance(v, list):
            out[name] = tuple(_np(x).tobytes() for x in v)
        else:
            arr = _np(v)
            out[name] = (arr.dtype.name, arr.shape, arr.tobytes())
    return out


class RankPreempted(BaseException):
    """A simulated rank was preempted mid-step: a ``BaseException``, so it
    passes the library's ``except Exception`` handlers as a SIGTERM would."""

    def __init__(self, rank: int, step: int) -> None:
        super().__init__(f"rank {rank} preempted at step {step}")
        self.rank = rank
        self.step = step


@dataclass(frozen=True)
class FaultProfile:
    """The fault and latency profile of a :class:`TorchFleetWorld`, as
    ``fake_world.FaultProfile``; its randomness comes from ``seed`` through
    ``zlib.crc32``, so a profile replays the same everywhere.

    - ``tier_size``: ranks ``[k*tier_size, (k+1)*tier_size)`` share a tier;
      a gather over ``k`` ranks pays ``k-1`` hops of ``inter_tier_latency_s``
      when it spans tiers, of ``intra_tier_latency_s`` otherwise;
    - ``preempt_at``: rank -> the step at which it is preempted for good;
    - ``preempt_hazard``: the per-(rank, step) chance of that;
    - ``straggler_ranks`` / ``straggler_delay_s``: a fixed extra delay;
    - ``drop_rounds``: rank -> ``(start, n)``: a transient partition over
      steps ``[start, start + n)``, judged at each observer's own step.
    """

    tier_size: int = 8
    intra_tier_latency_s: float = 0.0
    inter_tier_latency_s: float = 0.0
    jitter_s: float = 0.0
    preempt_at: Dict[int, int] = field(default_factory=dict)
    preempt_hazard: float = 0.0
    straggler_ranks: Tuple[int, ...] = ()
    straggler_delay_s: float = 0.0
    drop_rounds: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    seed: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "preempt_at", dict(self.preempt_at))
        object.__setattr__(self, "drop_rounds", dict(self.drop_rounds))
        object.__setattr__(self, "straggler_ranks", tuple(self.straggler_ranks))


class TorchFleetWorld(TorchLockstepWorld):
    """A fault-injecting fleet of thread ranks, the port's
    ``fake_world.FleetWorld``: rendezvous keyed by participant set (a
    survivor set gathers apart from a partitioned rank's quorum of one), the
    quorum transport itself (:meth:`probe`, :meth:`negotiate_allgather`,
    :meth:`subset_allgather`), and peers of a dead rank fail fast with
    ``SyncTimeoutError``. Per-(rank, participant set) round counters advance
    before any failure check, so a failed attempt uses the same slot on
    every rank. ``install`` also resets the resilience and tiering state and
    installs the world as the quorum transport; call :meth:`uninstall` after.
    """

    def __init__(self, world: int = 64, profile: Optional[FaultProfile] = None, gather_timeout_s: float = 10.0) -> None:
        super().__init__(world)
        self.profile = profile or FaultProfile()
        self.gather_timeout_s = gather_timeout_s
        self._full: FrozenSet[int] = frozenset(range(world))
        self._counters: Dict[Any, int] = {}
        self._fleet_entries: Dict[Any, Dict[str, Any]] = {}
        self._steps: Dict[int, int] = {}
        self._dead: set = set()
        self.preempted: set = set()
        self.gather_rounds_total = 0
        self.gather_rounds_degraded = 0
        self._prev_rank_provider: Optional[Callable[[], int]] = None

    # -- fault state ---------------------------------------------------------

    def _observer_step(self) -> int:
        observer = getattr(self._rank, "value", None)
        return self._steps.get(observer, -1) if observer is not None else -1

    def _in_drop(self, rank: int) -> bool:
        window = self.profile.drop_rounds.get(rank)
        if window is None:
            return False
        start, n_steps = window
        return start <= self._observer_step() < start + n_steps

    def _unreachable(self) -> set:
        """Ranks the calling rank cannot hear from: dead ones, those whose
        scheduled preemption step the observer reached, those in a drop
        window at the observer's step."""
        out = set(self._dead)
        at_step = self._observer_step()
        out.update(r for r, die in self.profile.preempt_at.items() if die <= at_step)
        out.update(r for r in self.profile.drop_rounds if self._in_drop(r))
        return out

    def begin_round(self, rank: int, step: int) -> None:
        """Advance ``rank`` to ``step``; fire a scheduled or hazard preemption."""
        profile = self.profile
        with self._cv:
            self._steps[rank] = step
            doomed = profile.preempt_at.get(rank) == step
            if not doomed and profile.preempt_hazard > 0.0:
                doomed = zlib.crc32(f"{profile.seed}:{rank}:{step}".encode()) / 2**32 < profile.preempt_hazard
            if doomed:
                self._dead.add(rank)
                self._cv.notify_all()
                raise RankPreempted(rank, step)

    def _inject_latency(self, rank: int, expected: FrozenSet[int], tag: Any) -> None:
        profile = self.profile
        delay = profile.straggler_delay_s if rank in profile.straggler_ranks else 0.0
        tiers = {r // profile.tier_size for r in expected}
        hop = profile.inter_tier_latency_s if len(tiers) > 1 else profile.intra_tier_latency_s
        delay += hop * (len(expected) - 1)
        if profile.jitter_s > 0.0:
            token = f"{profile.seed}:{rank}:{self._steps.get(rank, -1)}:{tag}"
            delay += profile.jitter_s * (zlib.crc32(token.encode()) / 2**32)
        if delay > 0.0:
            time.sleep(delay)

    # -- gathers -------------------------------------------------------------

    def _fleet_gather(self, x: torch.Tensor, expected: FrozenSet[int]) -> torch.Tensor:
        rank = self._rank.value
        with self._cv:
            key = (rank, "g", expected)
            round_idx = self._counters.get(key, 0)
            self._counters[key] = round_idx + 1  # before any failure check
            if self._in_drop(rank) and expected != frozenset({rank}):
                raise SyncTimeoutError(
                    f"[TorchFleetWorld] rank {rank} is partitioned: gather over {len(expected)} rank(s) did not "
                    "complete (peers dead or stalled)")
        self._inject_latency(rank, expected, round_idx)
        entry_key = ("g", expected, round_idx)
        with self._cv:
            entry = self._fleet_entries.setdefault(entry_key, {"vals": {}, "result": None, "readers": 0})
            entry["vals"][rank] = torch.as_tensor(x).detach().clone()
            if len(entry["vals"]) == len(expected):
                entry["result"] = torch.stack([entry["vals"][r] for r in sorted(expected)])
                self.calls += 1
                self.gather_rounds_total += 1
                if len(expected) < self.world:
                    self.gather_rounds_degraded += 1
                self._cv.notify_all()
            deadline = time.monotonic() + self.gather_timeout_s
            while entry["result"] is None:
                unreachable = (expected - set(entry["vals"])) & self._unreachable()
                if unreachable:
                    raise SyncTimeoutError(
                        f"[TorchFleetWorld] gather round {round_idx}: rank(s) {sorted(unreachable)} dead or stalled; "
                        f"{len(entry['vals'])}/{len(expected)} contributed")
                if time.monotonic() > deadline:
                    raise SyncTimeoutError(
                        f"[TorchFleetWorld] gather round {round_idx} over {len(expected)} rank(s) did not complete "
                        f"within {self.gather_timeout_s:.1f}s (dead or stalled peer)")
                self._cv.wait(0.02)
            out = entry["result"].clone()
            entry["readers"] += 1
            if entry["readers"] == len(expected):
                self._fleet_entries.pop(entry_key, None)
            return out

    def all_gather(self, x: torch.Tensor, group: Any = None, timeout_s: float = 60.0) -> List[torch.Tensor]:
        """The default world's collective (``sync._all_gather``'s seam)."""
        assert group is None, "a fleet gathers over its default world"
        return list(self._fleet_gather(x, self._full).unbind(0))

    # -- the quorum transport ------------------------------------------------

    def probe(self) -> Tuple[int, ...]:
        """The ranks this rank can reach, itself included."""
        rank = self._rank.value
        with self._cv:
            if self._in_drop(rank) or rank in self._dead:
                return (rank,)
            unreachable = self._unreachable()
        return tuple(r for r in range(self.world) if r not in unreachable)

    def subset_allgather(self, x: torch.Tensor, live: Any, timeout_s: float = 60.0) -> torch.Tensor:
        return self._fleet_gather(x, frozenset(int(r) for r in live))

    def negotiate_allgather(self, vec: Any, live: Any) -> np.ndarray:
        """A negotiation round over ``live``, keyed by the live set and a
        generation: a rank depositing again after a timed-out attempt
        overwrites its own slot."""
        rank = self._rank.value
        live = frozenset(int(r) for r in live)
        key = ("neg", live)
        with self._cv:
            entry = self._fleet_entries.setdefault(key, {"vals": {}, "gen": 0, "result": None})
            gen = entry["gen"]
            entry["vals"][rank] = np.asarray(vec).copy()
            if set(entry["vals"]) >= live:
                entry["result"] = np.stack([entry["vals"][r] for r in sorted(live)])
                entry["gen"] = gen + 1
                entry["vals"] = {}
                self._cv.notify_all()
                return entry["result"]
            deadline = time.monotonic() + self.gather_timeout_s
            while entry["gen"] == gen:
                dead = (live - set(entry["vals"])) & set(self._dead)
                if dead:
                    raise SyncTimeoutError(
                        f"[TorchFleetWorld] negotiation over {len(live)} rank(s): rank(s) {sorted(dead)} dead or "
                        "stalled")
                if time.monotonic() > deadline:
                    raise SyncTimeoutError(
                        f"[TorchFleetWorld] negotiation over {len(live)} rank(s) did not complete within "
                        f"{self.gather_timeout_s:.1f}s")
                self._cv.wait(0.02)
            return entry["result"]

    # -- driving -------------------------------------------------------------

    def run(self, fn: Callable[[int], Any], timeout: float = 120.0) -> List[Any]:
        """``fn(rank)`` on every rank: a :class:`RankPreempted` rank lands in
        ``preempted`` (not an error); a rank that raises is marked dead, so
        its peers fail fast; the first error is raised again here."""
        results: List[Any] = [None] * self.world
        errors: List[Optional[BaseException]] = [None] * self.world

        def body(rank: int) -> None:
            self._rank.value = rank
            try:
                results[rank] = fn(rank)
            except RankPreempted:
                with self._cv:
                    self.preempted.add(rank)
                    self._dead.add(rank)
                    self._cv.notify_all()
            except BaseException as err:  # noqa: BLE001 - raised again below
                errors[rank] = err
                with self._cv:
                    self._dead.add(rank)
                    self._cv.notify_all()

        threads = [threading.Thread(target=body, args=(r,), daemon=True, name=f"torch-fleet-rank{r}")
                   for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if any(t.is_alive() for t in threads):
            with self._cv:
                self._dead.update(range(self.world))
                self._cv.notify_all()
            raise RuntimeError("TorchFleetWorld deadlocked: a rank never finished its rounds")
        for err in errors:
            if err is not None:
                raise err
        return results

    # -- installation --------------------------------------------------------

    def install(self, monkeypatch: Any) -> "TorchFleetWorld":
        from metrics_tpu_torch.observability import journal

        resilience_mod.reset_resilience()
        tiering_mod.reset_tiering()
        super().install(monkeypatch)
        resilience_mod.set_quorum_transport(self)
        self._prev_rank_provider = journal.set_rank_provider(lambda: self.rank_domain() or 0)
        return self

    def uninstall(self) -> None:
        from metrics_tpu_torch.observability import journal

        resilience_mod.reset_resilience()
        tiering_mod.reset_tiering()
        if self._prev_rank_provider is not None:
            journal.set_rank_provider(self._prev_rank_provider)
            self._prev_rank_provider = None
        self.shutdown_executors()


__all__ = ["FaultProfile", "RankPreempted", "TorchFleetWorld", "TorchLockstepWorld", "WorldAxis", "state_bits"]
