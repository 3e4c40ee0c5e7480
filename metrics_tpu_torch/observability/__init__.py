"""metrics_tpu_torch.observability: telemetry of the metric runtime.

Counterpart of ``metrics_tpu.observability``, with its names:

- :mod:`~metrics_tpu_torch.observability.journal`: the event journal, an
  off-by-default per-thread ring recorder of typed runtime events (sync
  gathers and plans, health failures, watchdogs and margins, degradations,
  checkpoint saves, loads, prunes and refusals, compute-group form and
  detach), each with monotonic time, rank and step, and the
  :func:`on_event` subscriber hook;
- :mod:`~metrics_tpu_torch.observability.trace_export`: the journal as a
  Chrome-trace / Perfetto timeline, one process per rank;
- :mod:`~metrics_tpu_torch.observability.registry`: the stats registry
  behind ``Metric.telemetry()`` / ``MetricCollection.telemetry()``
  (``compile_stats()`` and ``sync_stats()`` are views of it), with deltas
  and JSON-lines / Prometheus encoders;
- :mod:`~metrics_tpu_torch.observability.diagnostics`: ``warn_once``.

Quick start::

    from metrics_tpu_torch import observability as obs

    obs.enable()                             # start recording
    ... evaluation loop ...
    obs.export_chrome_trace("trace.json")    # open in ui.perfetto.dev
    print(obs.telemetry_prometheus(metric.telemetry()))

No span reads the device: events carry the host's monotonic clock.
"""
from metrics_tpu_torch.observability import diagnostics, journal, registry, trace_export
from metrics_tpu_torch.observability.diagnostics import diag, warn_once
from metrics_tpu_torch.observability.journal import (
    EVENT_KINDS,
    Event,
    clear,
    disable,
    enable,
    enabled,
    events,
    on_event,
    record,
)
from metrics_tpu_torch.observability.registry import (
    TELEMETRY_SCHEMA,
    StatsRegistry,
    telemetry_jsonl,
    telemetry_prometheus,
)
from metrics_tpu_torch.observability.trace_export import chrome_trace, export_chrome_trace

__all__ = [
    "EVENT_KINDS",
    "TELEMETRY_SCHEMA",
    "Event",
    "StatsRegistry",
    "chrome_trace",
    "clear",
    "diag",
    "diagnostics",
    "disable",
    "enable",
    "enabled",
    "events",
    "export_chrome_trace",
    "journal",
    "on_event",
    "record",
    "registry",
    "telemetry_jsonl",
    "telemetry_prometheus",
    "trace_export",
    "warn_once",
]
