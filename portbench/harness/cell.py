"""One cell on one card: set-up, the measured window, the traced stretches
and the check, for each seed given.

The window is a closed loop with one caller: every pass folds the pass's
batches into the collection with ``update``, reads every value to the host
with ``compute()`` and ``reset()``s for the next pass. It closes at the end
of the pass in which ``seconds`` ran out, before that pass's ``reset()``, so
the check reads the state the window built.
"""
import gc
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from harness import gate, roofline, traffic, tracing
from harness.spec import Cell, load_module

SAMPLED_READS = 8


def build_collection(config: dict, device):
    import metrics_tpu_torch as mtt

    members = {k: getattr(mtt, s["class"])(**s.get("args", {}), device=device)
               for k, s in config["collection"]["members"].items()}
    return mtt.MetricCollection(members, compute_groups=config["collection"].get("compute_groups", True))


def read_states(mc) -> Dict[str, Dict[str, torch.Tensor]]:
    return {k: {n: v.detach().cpu() for n, v in m._state.items() if isinstance(v, torch.Tensor)}
            for k, m in mc.items()}


def read_values(mc) -> Dict[str, torch.Tensor]:
    """``compute()`` with every value on the host, as the user's read is."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.tensor(v)
            for k, v in mc.compute().items()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    reads: int
    steps: int
    wall_s: float
    t0_wall: float
    compute_s: List[float]
    pass_s: List[float]  # each pass: its updates, its read and its reset
    update_s: float
    sampled: list  # (read index, values), seeded, with the last read


def window(mc, steps, seconds: float, rng: random.Random) -> Window:
    compute_s, pass_s, update_s, sampled = [], [], 0.0, []
    reads = 0
    t0_wall, t0 = time.time(), time.perf_counter()
    p0 = t0
    while True:
        for p, t in steps:
            s0 = time.perf_counter()
            mc.update(p, t)
            update_s += time.perf_counter() - s0
        c0 = time.perf_counter()
        values = read_values(mc)
        compute_s.append(time.perf_counter() - c0)
        # reservoir sample of the reads, drawn from the seed
        if len(sampled) < SAMPLED_READS:
            sampled.append((reads, values))
        else:
            j = rng.randrange(reads + 1)
            if j < SAMPLED_READS:
                sampled[j] = (reads, values)
        reads += 1
        if time.perf_counter() - t0 >= seconds:
            pass_s.append(time.perf_counter() - p0)
            break
        mc.reset()
        p1 = time.perf_counter()
        pass_s.append(p1 - p0)
        p0 = p1
    wall = time.perf_counter() - t0
    if sampled[-1][0] != reads - 1:
        sampled.append((reads - 1, values))
    return Window(reads, reads * len(steps), wall, t0_wall, compute_s, pass_s, update_s, sampled)


@dataclass
class LayerContext:
    """What a per-layer reader reads: the traced run's window (host clock),
    the two profiled stretches after it, what a step needs and the card's
    peak."""

    window: Window
    steps: tracing.TraceWindow  # steady update steps only
    passes: tracing.TraceWindow  # whole passes: update, compute, reset
    need: dict
    peak: Optional[dict]


def _traced(mc, steps, mix: dict, device):
    """The two profiled stretches: the first ``trace_steps`` updates of a pass
    (then the pass finishes unprofiled), and ``trace_passes`` whole passes."""
    n = min(int(mix["trace_steps"]), len(steps))

    def updates(mark):
        for p, t in steps[:n]:
            with mark("update"):
                mc.update(p, t)
        return n, 0

    sync(device)
    tw_steps = tracing.profiled(updates)
    for p, t in steps[n:]:
        mc.update(p, t)
    read_values(mc)
    mc.reset()

    def passes(mark):
        for _ in range(int(mix["trace_passes"])):
            for p, t in steps:
                with mark("update"):
                    mc.update(p, t)
            with mark("compute"):
                read_values(mc)
            with mark("reset"):
                mc.reset()
        return int(mix["trace_passes"]) * len(steps), int(mix["trace_passes"])

    sync(device)
    return tw_steps, tracing.profiled(passes)


def warm_up(mc, steps, mix: dict) -> None:
    """The cell's own shapes, once each: a pass of ``warmup_steps[0]``
    updates (the eager steps and the capture), its read and reset, then
    passes of the rest (the first update after a ``reset()``, the replays)."""
    for n in mix["warmup_steps"]:
        for p, t in steps[:int(n)]:
            mc.update(p, t)
        read_values(mc)
        mc.reset()


def run_seed(cell: Cell, device, seed: int, seconds: float, trace: bool, control: bool,
             marks: Optional[Dict[str, float]] = None) -> dict:
    """One seed: set-up, the window, with ``trace`` the profiled stretches,
    then the check. ``marks`` gets the wall clock at the end of each step of
    set-up."""
    marks = {} if marks is None else marks
    cfg, mix = cell.config, cell.mix
    is_cuda = torch.device(device).type == "cuda"
    import metrics_tpu_torch  # noqa: F401

    marks["program"] = time.time()
    inputs = traffic.make_inputs(cfg, mix, seed, device)
    sync(device)
    marks["inputs"] = time.time()
    mc = build_collection(cfg, device)
    marks["collection"] = time.time()
    warm_up(mc, inputs.steps, mix)
    sync(device)
    marks["warm-up"] = time.time()
    win = window(mc, inputs.steps, seconds, random.Random(traffic.stream_seed(seed, *traffic.READS)))
    sync(device)
    states = read_states(mc)
    stats = mc.compile_stats()
    out = {"seed": seed, "reads": win.reads, "steps": win.steps,
           "samples": win.reads * inputs.samples_per_pass, "wall_s": win.wall_s, "t0_wall": win.t0_wall,
           "compute_s": win.compute_s, "pass_s": win.pass_s,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if is_cuda else 0,
           "fallback": {k: v["fallback"] for k, v in [("collection", stats["collection"]), *stats["members"].items()]
                        if v["fallback"]}}
    if trace:
        mc.reset()
        tw_steps, tw_passes = _traced(mc, inputs.steps, mix, device)
        name = torch.cuda.get_device_name(device) if is_cuda else "cpu"
        ctx = LayerContext(win, tw_steps, tw_passes, roofline.step_need(cfg, mix), roofline.peak(name))
        layer = {}
        for m in cell.per_layer:
            v = load_module("layer_metrics", m["name"]).read(ctx)
            if v is not None:
                layer[m["name"]] = float(v)
        out["layer"] = layer
        if tw_passes.device:
            lo, hi = tw_passes.span
            out["busy_s"] = tracing.busy_us(tw_passes.device, (lo, hi)) / 1e6
            out["window_s"] = (hi - lo) / 1e6
            out["breakdown"] = tracing.breakdown(tw_passes)
    # the program's state goes before the reference runs
    del mc
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    out.update(gate.check(cell, inputs, states, win.sampled, control))
    return out


def run_seeds(cell: Cell, device, seeds, seconds: float, trace: bool, control: bool = False,
              marks: Optional[Dict[str, float]] = None) -> List[dict]:
    return [run_seed(cell, device, s, seconds, trace, control, marks) for s in seeds]
