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

A 2-D world: ``TorchLockstepWorld(mesh=(("dp", 4), ("mp", 2)))`` lays the
ranks out row-major, as the JAX tests' ``devices.reshape(DP, MP)``;
``world.axis("dp")`` is the group handle of the current rank's "dp" slice
(the ranks that share its "mp" coordinate), ``world.axis("dp", "mp")`` the
whole world. A handle is what the port's ``process_group`` and
``axis_name`` take here; each group's collectives rendezvous on their own.
"""
import threading
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch

import metrics_tpu_torch.parallel.async_sync as async_mod
import metrics_tpu_torch.parallel.sync as sync_mod
from metrics_tpu_torch.parallel.async_sync import SerialExecutor


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
        rank, ranks = self._rank.value, self.participants(group)
        with self._cv:
            idx = self._rounds.get((rank, ranks), 0)
            self._rounds[(rank, ranks)] = idx + 1
            entry = self._entries.setdefault((ranks, idx), {"slots": {}, "read": 0})
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
                del self._entries[(ranks, idx)]
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


__all__ = ["TorchLockstepWorld", "WorldAxis"]
