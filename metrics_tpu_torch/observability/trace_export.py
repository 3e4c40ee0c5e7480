"""Chrome-trace / Perfetto export of the event journal.

Counterpart of ``metrics_tpu/observability/trace_export.py``: the recorded
journal (``observability/journal.py``) as Chrome trace-event JSON, the
format ``chrome://tracing`` and https://ui.perfetto.dev load:

- each **rank** is one trace process (``pid`` = rank);
- ``tid`` 0 is the rank's **step lane**: compiled dispatches and sync
  resolves as spans, every other event (gathers, health, degradations,
  checkpoints, compute groups) as an instant;
- ``tid`` 1 is the **sync lane**: an overlapped round's gather as its own
  span, correlated across ranks by ``args.sync_epoch``.

Timestamps are the journal's monotonic clock in microseconds, re-based to
the earliest span start, so a trace starts near zero and no event is
negative. Until the compiled path and overlapped sync are ported, this
package's journals hold instants only.
"""
import json
from typing import Any, Dict, Iterable, List, Optional

from metrics_tpu_torch.observability import journal

__all__ = ["chrome_trace", "export_chrome_trace"]

#: tid of the foreground (step) lane and the background sync lane.
STEP_LANE = 0
SYNC_LANE = 1

#: Event classes rendered as instants on the step lane (everything that is
#: a fact, not a span).
_INSTANT_CLASSES = ("health", "degrade", "checkpoint", "group")


def _args(ev: journal.Event) -> Dict[str, Any]:
    out = {"step": ev.step, **{k: v for k, v in ev.fields.items()}}
    return {k: (v if isinstance(v, (int, float, str, bool)) or v is None else str(v))
            for k, v in out.items()}


def chrome_trace(events: Optional[Iterable[journal.Event]] = None) -> Dict[str, Any]:
    """Build the Chrome trace-event dict from ``events`` (defaults to the
    full recorded journal). Returns ``{"traceEvents": [...], ...}`` — pass
    through :func:`export_chrome_trace` to write it to disk."""
    evs: List[journal.Event] = list(journal.events() if events is None else events)
    trace: List[Dict[str, Any]] = []
    if not evs:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(e.ts for e in evs)
    # spans are recorded at their END (dispatch durations, resolve waits,
    # background gathers) — include every span's start in the re-base so no
    # trace event goes negative
    for e in evs:
        if e.kind == "sync.resolve" and "gather_start" in e.fields:
            base = min(base, float(e.fields["gather_start"]))
        if e.kind == "compiled.dispatch":
            base = min(base, e.ts - float(e.fields.get("dur_s", 0.0)))
        if e.kind == "sync.resolve":
            base = min(base, e.ts - float(e.fields.get("wait_s", 0.0)))
        if e.kind == "sync.hop":
            base = min(base, e.ts - float(e.fields.get("dur_s", 0.0)))

    def us(ts: float) -> float:
        return (ts - base) * 1e6

    ranks = sorted({e.rank for e in evs})
    for rank in ranks:
        trace.append({
            "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
            "args": {"name": f"rank {rank}"},
        })
        trace.append({
            "ph": "M", "name": "thread_name", "pid": rank, "tid": STEP_LANE,
            "args": {"name": "step"},
        })
        trace.append({
            "ph": "M", "name": "thread_name", "pid": rank, "tid": SYNC_LANE,
            "args": {"name": "sync-background"},
        })

    for ev in evs:
        cls = ev.kind.partition(".")[0]
        args = _args(ev)
        if ev.kind == "compiled.dispatch":
            dur = float(ev.fields.get("dur_s", 0.0)) * 1e6
            trace.append({
                "ph": "X", "name": f"dispatch {ev.label}", "cat": "compiled",
                "pid": ev.rank, "tid": STEP_LANE,
                "ts": us(ev.ts) - dur, "dur": dur, "args": args,
            })
        elif ev.kind == "sync.resolve":
            epoch = ev.fields.get("sync_epoch")
            gather_start = ev.fields.get("gather_start")
            gather_s = float(ev.fields.get("gather_s", 0.0))
            if gather_start is not None:
                # the background lane's span: the collectives themselves
                trace.append({
                    "ph": "X", "name": f"gather {ev.label}", "cat": "sync",
                    "pid": ev.rank, "tid": SYNC_LANE,
                    "ts": us(float(gather_start)), "dur": gather_s * 1e6,
                    "args": args,
                })
            wait_us = float(ev.fields.get("wait_s", 0.0)) * 1e6
            trace.append({
                "ph": "X", "name": f"resolve {ev.label}", "cat": "sync",
                "pid": ev.rank, "tid": STEP_LANE,
                "ts": us(ev.ts) - wait_us, "dur": wait_us,
                "args": args,
            })
            if epoch is not None:
                # flow step ties the cross-rank round together visually
                trace.append({
                    "ph": "f", "bp": "e", "id": int(epoch), "cat": "sync-epoch",
                    "name": f"epoch {epoch}", "pid": ev.rank, "tid": SYNC_LANE,
                    "ts": us(ev.ts),
                })
        elif ev.kind == "sync.launch":
            trace.append({
                "ph": "i", "s": "t", "name": f"launch {ev.label}", "cat": "sync",
                "pid": ev.rank, "tid": STEP_LANE, "ts": us(ev.ts), "args": args,
            })
            epoch = ev.fields.get("sync_epoch")
            if epoch is not None:
                trace.append({
                    "ph": "s", "id": int(epoch), "cat": "sync-epoch",
                    "name": f"epoch {epoch}", "pid": ev.rank, "tid": SYNC_LANE,
                    "ts": us(ev.ts),
                })
        elif ev.kind == "sync.hop":
            # the tiered schedule's two hop classes render as their own
            # categories so the fast (intra-tier) and slow (inter-tier)
            # wires are distinguishable (color + filter) in Perfetto
            dur = float(ev.fields.get("dur_s", 0.0)) * 1e6
            trace.append({
                "ph": "X",
                "name": f"{ev.label}-tier hop (tier {ev.fields.get('tier', -1)})",
                "cat": f"sync-{ev.label}-tier",
                "pid": ev.rank, "tid": SYNC_LANE,
                "ts": us(ev.ts) - dur, "dur": dur, "args": args,
            })
        elif ev.kind in ("sync.gather", "sync.plan", "sync.drain"):
            trace.append({
                "ph": "i", "s": "t", "name": f"{ev.kind.partition('.')[2]} {ev.label}",
                "cat": "sync", "pid": ev.rank, "tid": STEP_LANE,
                "ts": us(ev.ts), "args": args,
            })
        elif ev.kind in ("compiled.trace", "compiled.fallback"):
            trace.append({
                "ph": "i", "s": "t", "name": f"{ev.kind} {ev.label}",
                "cat": "compiled", "pid": ev.rank, "tid": STEP_LANE,
                "ts": us(ev.ts), "args": args,
            })
        elif cls in _INSTANT_CLASSES:
            scope = "p" if cls == "health" else "t"  # process-wide health marks
            trace.append({
                "ph": "i", "s": scope, "name": f"{ev.kind} {ev.label}".strip(),
                "cat": cls, "pid": ev.rank, "tid": STEP_LANE,
                "ts": us(ev.ts), "args": args,
            })
        else:  # unknown/future kinds degrade to generic instants
            trace.append({
                "ph": "i", "s": "t", "name": ev.kind, "cat": cls,
                "pid": ev.rank, "tid": STEP_LANE, "ts": us(ev.ts), "args": args,
            })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def export_chrome_trace(
    path: Optional[str] = None,
    events: Optional[Iterable[journal.Event]] = None,
) -> Dict[str, Any]:
    """Render the journal as Chrome-trace JSON; write it to ``path`` when
    given. Returns the trace dict either way. Load the file in
    ``chrome://tracing`` or https://ui.perfetto.dev."""
    trace = chrome_trace(events)
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
