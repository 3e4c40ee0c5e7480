"""Traced windows: ``torch.profiler`` over steady update steps and over
whole passes, reduced to plain interval lists that the per-layer readers
count and intersect.

The counting rules are copied from ``chip_smoke.py``'s ``_sync_events``,
``_host_reads`` and ``_profile_counts`` (commit 1e60dca8): a host read is a
``cudaStreamSynchronize`` host event or a device-to-host copy, a graph
launch a ``cudaGraphLaunch`` host event, and device busy time the time some
device operation ran. The harness's own ``torch.cuda.synchronize()`` is a
``cudaDeviceSynchronize`` and is not counted.
"""
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

MARK = "portbench."
Interval = Tuple[str, float, float]  # name, start us, end us (the trace's clock)


@dataclass
class TraceWindow:
    """One profiled stretch: ``steps`` update calls and ``reads`` pass-end
    reads; device activity (kernels, copies, sets), host events, and the
    harness's own markers around each ``update``/``compute``/``reset``."""

    steps: int
    reads: int
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    markers: List[Interval] = field(default_factory=list)
    # (start us of the host operation, device us of one operation it launched):
    # the profiler links each device operation to the host operation that
    # launched it, wherever in the queue the device ran it
    launched: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def span(self) -> Tuple[float, float]:
        return self.markers[0][1], max(e for _, _, e in self.markers)

    def marked(self, what: str) -> List[Tuple[float, float]]:
        return [(s, e) for n, s, e in self.markers if n == MARK + what]

    def kernels(self) -> List[Interval]:
        return [iv for iv in self.device if not iv[0].startswith(("Memcpy", "Memset"))]

    def host_named(self, name: str) -> int:
        return sum(1 for n, _, _ in self.host if n == name)


def union(intervals: Iterable[Tuple[float, float]], clip: Optional[Tuple[float, float]] = None) -> List[Tuple[float, float]]:
    """Disjoint sorted intervals covering ``intervals`` (within ``clip``)."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if clip is not None:
            s, e = max(s, clip[0]), min(e, clip[1])
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def busy_us(device: Sequence[Interval], clip: Optional[Tuple[float, float]] = None) -> float:
    """Microseconds in which some device operation ran."""
    return covered(union(((s, e) for _, s, e in device), clip))


def launched_within_us(launched: Sequence[Tuple[float, float]], ranges: Sequence[Tuple[float, float]]) -> float:
    """Device microseconds of the operations launched by host operations that
    start inside ``ranges``: the device work of those calls, not of the work
    queued before them that the device runs meanwhile."""
    spans = union(ranges)
    return sum(d for t, d in launched if any(s <= t < e for s, e in spans))


def profiled(fn) -> TraceWindow:
    """Run ``fn(mark)`` under ``torch.profiler`` (``mark(what)`` gives the
    context that brackets one call) and reduce the profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        steps, reads = fn(lambda what: record_function(MARK + what))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    tw = TraceWindow(steps, reads)
    for ev in prof.events():
        iv = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.name.startswith(MARK):
            if ev.device_type == DeviceType.CPU:
                tw.markers.append(iv)
        elif ev.device_type == DeviceType.CPU:
            tw.host.append(iv)
            tw.launched.extend((iv[1], float(k.duration)) for k in ev.kernels)
        else:
            tw.device.append(iv)
    tw.markers.sort(key=lambda iv: iv[1])
    return tw


def breakdown(tw: TraceWindow, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the device labelled by what the host was doing at their start: the
    harness's marker and the innermost host event then running."""
    per_op: dict = {}
    for n, s, e in tw.device:
        per_op[n] = per_op.get(n, 0.0) + (e - s)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = tw.span
    busy = union(((s, e) for _, s, e in tw.device), (lo, hi))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:top]

    def label(t: float) -> str:
        mark = next((n[len(MARK):] for n, s, e in tw.markers if s <= t < e), "harness")
        inner = [(e - s, n) for n, s, e in tw.host if s <= t < e]
        return mark + (":" + min(inner)[1] if inner else "")

    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[label(s), (e - s) / 1e6] for s, e in gaps]}
