"""The tiered schedule's int8 slow hop on the card. It imports nothing of JAX,
so that it runs on a machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_tiered_cuda.py

Without a card the case skips inside the test. Four thread ranks
(``tests/helpers/torch_world.py``), two tiers of two, states on the card:
the codec runs on the card before the wire reaches the transport, and the
wires the leaders exchange, the synced states and the byte counters equal
the same sync of the same states on the CPU, bit for bit (the in-tier
partial adds in rank order on both; the int8 encode is elementwise IEEE
arithmetic and a half-to-even round). The CPU run is held to the JAX package
in ``tests/test_torch_tiered_sync.py``.
"""
import numpy as np
import pytest
import torch

from metrics_tpu_torch.core.cat_buffer import CatBuffer
from metrics_tpu_torch.parallel import tiering
from metrics_tpu_torch.parallel.sync import host_sync_state
# pytest puts tests/ on the path (no __init__.py there); a ``tests`` package
# installed elsewhere would shadow ``tests.helpers``, so the helper is
# imported as ``helpers``
from helpers.torch_world import TorchLockstepWorld

WORLD, TIER, N = 4, 2, 70_000


def _state(rank, device):
    rng = np.random.RandomState(rank)
    buf = CatBuffer(64)  # its buffer takes the device of its first rows
    buf.append(torch.from_numpy(rng.standard_normal((3 + rank, 5)).astype(np.float32)).to(device))
    x = (rng.standard_normal(N) * np.exp(rng.uniform(-6, 6, N))).astype(np.float32)
    return {
        "total": torch.from_numpy(x).to(device),
        "peak": torch.from_numpy(x[:257] * 3).to(device),
        "count": torch.tensor([rank + 1, 7], dtype=torch.int32, device=device),
        "rows": buf,
    }, {"total": "sum", "peak": "max", "count": "sum", "rows": "cat"}


def _run(device, monkeypatch):
    wires = []
    with monkeypatch.context() as mp:
        world = TorchLockstepWorld(WORLD).install(mp)
        inner = world.subset_allgather

        def recording(x, ranks, timeout_s=60.0):
            if x.dtype == torch.int8:
                wires.append((world._rank.value, x.cpu().clone()))
            return inner(x, ranks, timeout_s)

        world.subset_allgather = recording
        tiering.set_tier_map(TIER)
        tiering.set_tier_transport(world)
        try:

            def body(rank):
                state, reds = _state(rank, device)
                stats = {}
                synced = host_sync_state(state, reds, update_count=1, timeout=0, sync_precision="int8", stats=stats)
                assert all(v.device.type == torch.device(device).type for k, v in synced.items() if k != "rows")
                return {k: (v.values() if k == "rows" else v).cpu() for k, v in synced.items()}, stats

            out = world.run(body)
        finally:
            tiering.reset_tiering()
            world.shutdown_executors()
    return out, sorted(wires, key=lambda rw: rw[0])


@pytest.mark.cuda
def test_int8_tiered_sync_on_the_card_equals_the_cpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card, card_wires = _run("cuda", monkeypatch)
    host, host_wires = _run("cpu", monkeypatch)
    assert len(card_wires) == len(host_wires) > 0
    for (rank_a, a), (rank_b, b) in zip(card_wires, host_wires):
        assert rank_a == rank_b and torch.equal(a, b), rank_a
    for rank in range(WORLD):
        (got, got_stats), (want, want_stats) = card[rank], host[rank]
        assert got_stats == want_stats and got_stats["intra_tier_bytes"] > 0
        for name in want:
            assert torch.equal(got[name], want[name]), (rank, name)
    assert all(card[leader][1]["inter_tier_bytes"] > 0 for leader in range(0, WORLD, TIER))
