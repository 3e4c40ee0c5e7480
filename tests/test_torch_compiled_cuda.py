"""The compiled hot path on the card: CUDA-graph replays. It imports nothing
of JAX, so that it runs on a machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_compiled_cuda.py

Without a card each case skips inside the test. The CPU twins of these
cases are in ``tests/test_torch_compiled.py``. A replay runs the kernels an
eager step runs, in the same order, so compiled and eager states and values
are equal bit for bit (``torch.equal``).
"""
import numpy as np
import pytest
import torch

import metrics_tpu_torch as port
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.ops import binned_stats
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

N_STEPS, BATCH = 6, 256


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(device, seed=17):
    rng = np.random.RandomState(seed)
    preds = torch.from_numpy(rng.rand(N_STEPS, BATCH, 10).astype(np.float32)).to(device)
    target = torch.from_numpy(rng.randint(0, 10, (N_STEPS, BATCH))).to(device)
    rows = torch.from_numpy(rng.rand(N_STEPS, BATCH).astype(np.float32)).to(device)
    return preds, target, rows


class CatMetric(Metric):
    def __init__(self, device):
        super().__init__(device=device)
        self.add_state("rows", [], dist_reduce_fx="cat")

    def update(self, x):
        self.rows.append(x)

    def compute(self):
        return torch.sum(dim_zero_cat(self.rows))


def _stat_collection(device, knob):
    k = dict(num_classes=10, average="macro", device=device)
    mc = port.MetricCollection({"prec": port.Precision(**k), "rec": port.Recall(**k), "f1": port.F1(**k),
                                "stats": port.StatScores(reduce="macro", num_classes=10, device=device)})
    for m in mc.values():
        m.compiled_update = knob
    return mc


def _states(mc):
    return {f"{k}.{n}": v for k, m in mc.items() for n, v in m._state.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["update", "forward"])
def test_replays_equal_eager_bit_for_bit(call):
    device = _card()
    preds, target, _ = _data(device)
    eager, compiled = _stat_collection(device, False), _stat_collection(device, True)
    for i in range(N_STEPS):
        ve, vc = getattr(eager, call)(preds[i], target[i]), getattr(compiled, call)(preds[i], target[i])
        if call == "forward":
            assert all(torch.equal(ve[k], vc[k]) for k in ve), i
    se, sc = _states(eager), _states(compiled)
    assert all(torch.equal(se[k], sc[k]) for k in se)
    assert all(torch.equal(a, b) for a, b in zip(eager.compute().values(), compiled.compute().values()))
    cs = compiled.compile_stats()
    assert cs["collection"]["dispatches"] + sum(s["dispatches"] for s in cs["members"].values()) > 0
    assert cs["collection"]["fallback"] is None and all(s["fallback"] is None for s in cs["members"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["getattr", "state_dict", "compute"])
def test_handed_out_state_keeps_its_value_across_replays(how):
    device = _card()
    preds, target, _ = _data(device)
    m = port.StatScores(reduce="macro", num_classes=10, device=device)
    m.compiled_update = True
    m.persistent(True)
    m.update(preds[0], target[0])
    m.update(preds[1], target[1])
    held = {"getattr": lambda: m.tp, "state_dict": lambda: m.state_dict()["tp"], "compute": m.compute}[how]()
    before = held.clone()
    for i in range(2, N_STEPS):
        m.update(preds[i], target[i])
    torch.cuda.synchronize()
    assert torch.equal(held, before)
    assert m.compile_stats()["dispatches"] == N_STEPS


@pytest.mark.cuda
def test_catbuffer_appends_at_the_device_offset_and_overflow_raises_first():
    device = _card()
    _, _, rows = _data(device)
    m = CatMetric(device).with_capacity(BATCH * 4)
    m.compiled_update = True
    for i in range(4):
        m.update(rows[i])
    assert m.compile_stats()["dispatches"] == 3  # the first update materializes the buffer
    assert torch.equal(m.rows.values(), rows[:4].reshape(-1))
    with pytest.raises(MetricsTPUUserError, match="overflow"):
        m.update(rows[4])
    assert len(m.rows) == 4 * BATCH and torch.equal(m.compute(), torch.sum(rows[:4].reshape(-1)))
    m.reset()
    m.update(rows[5])
    m.update(rows[0])
    assert torch.equal(m.rows.values(), torch.cat([rows[5], rows[0]]))


@pytest.mark.cuda
def test_b1_inside_a_replay_is_counted_and_equal_to_its_twin():
    device = _card()
    preds, target, _ = _data(device)
    m = port.BinnedAveragePrecision(num_classes=10, thresholds=50, device=device)
    m.compiled_update = True
    launches = binned_stats.KERNEL_LAUNCHES
    for i in range(N_STEPS):
        m.update(preds[i], target[i])
    torch.cuda.synchronize()
    stats = m.compile_stats()
    assert stats["dispatches"] > 0 and stats["fallback"] is None
    # one launch a step, plus one in each program's eager warm-up
    assert binned_stats.KERNEL_LAUNCHES - launches == N_STEPS + stats["traces"]
    cpu = port.BinnedAveragePrecision(num_classes=10, thresholds=50, device="cpu")
    cpu.compiled_update = False
    for i in range(N_STEPS):
        cpu.update(preds[i].cpu(), target[i].cpu())
    for name, v in m._state.items():
        assert torch.equal(v.cpu(), cpu._state[name]), name


# ---- compiled_step: the whole step as one CUDA graph ------------------------


def _report(device):
    k = dict(num_classes=10, average="macro", device=device)
    return port.MetricCollection({"prec": port.Precision(**k), "rec": port.Recall(**k), "f1": port.F1(**k),
                                  "spec": port.Specificity(**k), "confmat": port.ConfusionMatrix(10, device=device)})


def _phases(mc, preds, target):
    state = mc.init_state()
    for i in range(N_STEPS):
        state = mc.pure_update(state, preds[i], target[i])
    return state, mc.pure_compute(state)


@pytest.mark.cuda
def test_compiled_step_is_one_graph_equal_to_the_phases():
    """One graph a step; the state threads through the program's own buffers
    (no copy-in) and equals the separate phases bit for bit; B1 replays
    inside the step's graph, counted one launch a call."""
    device = _card()
    preds, target, _ = _data(device)
    mc = _report(device)
    state = mc.init_state()
    for i in range(N_STEPS):
        state, values = mc.compiled_step(state, preds[i], target[i])
    torch.cuda.synchronize()
    want_state, want = _phases(_report(device), preds, target)
    for k in want_state:
        for name, v in want_state[k].items():
            assert torch.equal(state[k][name], v), (k, name)
    for k in want:
        assert torch.equal(values[k], want[k]), k
    cs = mc.compile_stats()["collection"]
    assert cs["traces"] == 1 and cs["dispatches"] == N_STEPS and cs["fallback"] is None
    binned = port.BinnedAveragePrecision(num_classes=10, thresholds=50, device=device)
    launches = binned_stats.KERNEL_LAUNCHES
    bstate = binned.init_state()
    for i in range(N_STEPS):
        bstate, bvalue = binned.compiled_step(bstate, preds[i], target[i])
    torch.cuda.synchronize()
    # one a step, and one in the program's eager warm-up
    assert binned_stats.KERNEL_LAUNCHES - launches == N_STEPS + 1
    cpu = port.BinnedAveragePrecision(num_classes=10, thresholds=50, device="cpu")
    cstate = cpu.init_state()
    for i in range(N_STEPS):
        cstate = cpu.pure_update(cstate, preds[i].cpu(), target[i].cpu())
    assert all(torch.equal(bstate[n].cpu(), v) for n, v in cstate.items())


@pytest.mark.cuda
def test_compiled_step_inside_a_callers_capture_runs_inline():
    device = _card()
    preds, target, _ = _data(device)
    mc = _report(device)
    state = mc.init_state()
    state, _ = mc.compiled_step(state, preds[0], target[0])  # types every state
    static = {k: {n: v.clone() for n, v in s.items()} for k, s in state.items()}
    x, y = preds[1].clone(), target[1].clone()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out_state, out_values = mc.compiled_step(static, x, y)
    graph.replay()
    torch.cuda.synchronize()
    assert mc.telemetry()["collection"]["plan"]["fused_steps"] == 2  # the eager step, then once inline
    ref = _report(device)
    rs = ref.pure_update(ref.pure_update(ref.init_state(), preds[0], target[0]), preds[1], target[1])
    want = ref.pure_compute(rs)
    assert all(torch.equal(out_values[k], want[k]) for k in want)


@pytest.mark.cuda
def test_compiled_step_captures_a_one_rank_nccl_sync_and_refuses_gloo():
    import socket

    import torch.distributed as dist

    device = _card()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port_no}", world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        preds, target, _ = _data(device)
        synced_mc, local_mc = _report(device), _report(device)
        st_s, st_l = synced_mc.init_state(), local_mc.init_state()
        for i in range(N_STEPS):
            st_s, v_s = synced_mc.compiled_step(st_s, preds[i], target[i], axis_name=dist.group.WORLD)
            st_l, v_l = local_mc.compiled_step(st_l, preds[i], target[i])
        torch.cuda.synchronize()
        assert all(torch.equal(v_s[k], v_l[k]) for k in v_l)  # one rank: the sum is the value
        assert synced_mc.compile_stats()["collection"]["fallback"] is None
        gloo = dist.new_group(backend="gloo")
        m = port.Precision(num_classes=10, average="macro", device=device)
        with pytest.raises(MetricsTPUUserError, match="NCCL"):
            m.compiled_step(m.init_state(), preds[0], target[0], axis_name=gloo)
    finally:
        dist.destroy_process_group()
