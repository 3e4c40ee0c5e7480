"""A world of ranks on threads for the PyTorch port's host sync.

The port's counterpart of :class:`tests.helpers.fake_world.LockstepWorld`:
``fn(rank)`` runs on one thread per rank, and every collective of
``metrics_tpu_torch.parallel.sync`` (its one seam, ``_all_gather``) becomes a
barrier rendezvous that hands every rank what every rank contributed. The
real sync code runs on each rank, in one process, with no process group.

Install with ``world.install(monkeypatch)``: it also reports a distributed
world of ``world`` ranks with collectives on the host, and turns the
watchdog off (``METRICS_TPU_SYNC_TIMEOUT_S=0``), since its worker thread
would not carry the rank's identity.
"""
import threading
from typing import Any, Callable, List, Optional

import torch

import metrics_tpu_torch.parallel.sync as sync_mod


class TorchLockstepWorld:
    """``calls`` counts collective rounds (one per rendezvous, not per
    rank); ``bytes`` the bytes all ranks put into them. A rank that raises
    aborts the barrier, so its peers fail fast instead of waiting."""

    def __init__(self, world: int = 2) -> None:
        self.world = world
        self.calls = 0
        self.bytes = 0
        self._barrier = threading.Barrier(world)
        self._slots: List[Optional[torch.Tensor]] = [None] * world
        self._rank = threading.local()

    def install(self, monkeypatch: Any) -> "TorchLockstepWorld":
        monkeypatch.setattr(sync_mod, "_all_gather", self.all_gather)
        monkeypatch.setattr(sync_mod, "_world_size", lambda group=None: self.world)
        monkeypatch.setattr(sync_mod, "distributed_available", lambda group=None: True)
        monkeypatch.setattr(sync_mod, "_collective_device", lambda group=None: torch.device("cpu"))
        monkeypatch.setenv("METRICS_TPU_SYNC_TIMEOUT_S", "0")
        return self

    def all_gather(self, x: torch.Tensor, group: Any = None) -> List[torch.Tensor]:
        rank = self._rank.value
        self._slots[rank] = x.detach().clone()
        if self._barrier.wait() == 0:
            self.calls += 1
            self.bytes += sum(s.numel() * s.element_size() for s in self._slots)
        out = [s.clone() for s in self._slots]
        # every rank reads before the next round overwrites; a peer that
        # raised right after reading may break this second barrier, which is
        # harmless once the gather itself completed
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            pass
        return out

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
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), daemon=True) for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if any(t.is_alive() for t in threads):
            self._barrier.abort()
            raise RuntimeError("TorchLockstepWorld deadlocked: a rank never reached the barrier")
        self._barrier.reset()
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
                self._barrier.abort()
                return type(err)

        return self.run(catching, timeout)
