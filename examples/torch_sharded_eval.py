"""Distributed eval over ranks, in PyTorch: the counterpart of
``examples/sharded_eval.py``.

Each rank folds its shard of the eval set into a metric state with the pure
state API (``pure_update`` over its batches), syncs the state over the
process group with the in-program collectives (``pure_sync``: all-reduce
for the scalar states, all-gather and compaction for AUROC's CatBuffer,
``parallel/sync.py::sync_in_jit``), and computes the GLOBAL values on every
rank. Rank 0 then holds them against one collection updated with all rows.

Ranks come from ``torchrun`` (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT``), or, when none is set, from a spawn here: one rank per card
over NCCL (NCCL takes one rank a card), or ``--world`` ranks over gloo with
``--device cpu``; a world of one runs in this process.

    python examples/torch_sharded_eval.py                      # one rank a card, NCCL
    python examples/torch_sharded_eval.py --device cpu         # two ranks, gloo
    torchrun --nproc-per-node 4 examples/torch_sharded_eval.py  # four cards
"""
import argparse
import os
import socket
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from metrics_tpu_torch import AUROC, Accuracy, MetricCollection  # noqa: E402
from metrics_tpu_torch.utils.device import resolve_device  # noqa: E402

ROWS_PER_RANK = 512
BATCHES = 4  # a rank's shard in 4 batches, as the JAX example's scan
NUM_CLASSES = 2
ATOL = 1e-6


def eval_data(world: int) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX example's eval set for ``world`` ranks: logits and labels of
    ``world * 512`` rows from ``RandomState(0)``."""
    rows = world * ROWS_PER_RANK
    rng = np.random.RandomState(0)
    logits = rng.randn(rows, NUM_CLASSES).astype(np.float32)
    target = (logits[:, 1] + 0.5 * rng.randn(rows) > 0).astype(np.int64)
    return logits, target


def eval_rank(rank: int, world: int, group: Any, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """One rank's eval: ``pure_update`` over its contiguous shard in
    ``BATCHES`` batches, ``pure_sync`` over ``group``, ``pure_compute``;
    the global values."""
    logits, target = eval_data(world)
    shard = slice(rank * ROWS_PER_RANK, (rank + 1) * ROWS_PER_RANK)
    lg = torch.from_numpy(logits[shard]).to(device).reshape(BATCHES, -1, NUM_CLASSES)
    tg = torch.from_numpy(target[shard]).to(device).reshape(BATCHES, -1)
    metrics = MetricCollection({
        "acc": Accuracy(num_classes=NUM_CLASSES, device=device),
        "auroc": AUROC(num_classes=NUM_CLASSES, device=device).with_capacity(ROWS_PER_RANK),  # per-RANK rows
    })
    # one eager batch latches the input mode and sizes the buffers
    metrics.update(torch.softmax(lg[0, :8], dim=-1), tg[0, :8])
    metrics.reset()
    state = metrics.init_state()
    for x, y in zip(lg, tg):
        state = metrics.pure_update(state, torch.softmax(x, dim=-1), y)
    synced = metrics.pure_sync(state, group)
    return metrics.pure_compute(synced)


def reference(world: int, device: Union[str, torch.device]) -> Dict[str, float]:
    """One collection updated with every row at once."""
    logits, target = eval_data(world)
    ref = MetricCollection({
        "acc": Accuracy(num_classes=NUM_CLASSES, device=device),
        "auroc": AUROC(num_classes=NUM_CLASSES, device=device),
    })
    ref.update(torch.softmax(torch.from_numpy(logits).to(device), dim=-1), torch.from_numpy(target).to(device))
    return {k: float(v) for k, v in ref.compute().items()}


def check(values: Dict[str, torch.Tensor], expect: Dict[str, float]) -> Dict[str, float]:
    """Each synced value within ``ATOL`` of the one-collection reference;
    the errors."""
    errs = {k: abs(float(v) - expect[k]) for k, v in values.items()}
    for k, err in errs.items():
        assert err < ATOL, (k, float(values[k]), expect[k])
    return errs


def _run_rank(rank: int, world: int, device: str, init_method: str) -> Dict[str, float]:
    """Join the group and evaluate; rank 0 then leaves the group and holds
    the values against the one-collection reference (which must not sync).
    ``device`` "cuda" means card ``rank``."""
    import torch.distributed as dist

    dev = resolve_device(f"cuda:{rank}" if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **({"device_id": dev} if backend == "nccl" else {}))
    try:
        values = eval_rank(rank, world, dist.group.WORLD, dev)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(f"ranks: {world} x {dev.type} ({backend})")
        print({k: round(float(v), 4) for k, v in values.items()})
        check(values, reference(world, dev))
        print("matches single-device reference ✓")
    return {k: float(v) for k, v in values.items()}


def _spawned(rank: int, world: int, device: str, init_method: str) -> None:
    _run_rank(rank, world, device, init_method)


def main(argv: Optional[Sequence[str]] = None) -> Optional[Dict[str, float]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default: one rank a card) or cpu")
    parser.add_argument("--world", type=int, default=None, help="ranks to spawn without torchrun (cpu: 2)")
    args = parser.parse_args(argv)
    if "RANK" in os.environ:  # torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = os.environ.get("LOCAL_RANK", str(rank))
        device = "cpu" if args.device == "cpu" else f"cuda:{local}"
        return _run_rank(rank, world, device, "env://")
    if args.device == "cpu":
        world = args.world or 2
    else:
        resolve_device(args.device)  # raises without a card
        world = args.world or torch.cuda.device_count()
        if world > torch.cuda.device_count():
            raise ValueError(f"NCCL takes one rank a card: {world} ranks on {torch.cuda.device_count()} cards")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        init_method = f"tcp://localhost:{s.getsockname()[1]}"
    if world == 1:
        return _run_rank(0, 1, args.device, init_method)
    torch.multiprocessing.spawn(_spawned, args=(world, args.device, init_method), nprocs=world, join=True)
    return None


if __name__ == "__main__":
    main()
