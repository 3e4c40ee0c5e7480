"""Per-instance stats registry behind ``telemetry()``.

Counterpart of ``metrics_tpu/observability/registry.py``: the same domains,
counters, defaults and schema id (``metrics_tpu.telemetry.v1``), so that one
log shipper reads the snapshots of both packages.

- ``sync`` is what ``Metric.sync_stats()`` / ``MetricCollection.sync_stats()``
  read: the overlapped rounds' ledger (``parallel/async_sync.py`` through
  ``core/metric.py`` and ``core/collections.py``): ``launched``,
  ``resolved``, ``stale_resolves``, ``cancelled``, ``served_local``,
  ``degraded`` (a resolve that fell back to local state), ``gather_s``,
  ``resolve_wait_s`` and ``overlap_saved_s``. Blocking syncs count no round,
  as in the JAX package. The tier byte counters (``intra_tier_bytes``,
  ``inter_tier_bytes``, ``inter_tier_bytes_saved``) take what each hop of a
  tiered sync put on the wire (``parallel/bucketing.py``).
- ``compile`` is what ``compile_stats()`` reads
  (``core/compiled.py::compile_stats_view``),
  counted by the compiled hot path (``core/compiled.py``); ``plan`` counts
  the plan store's ``builds`` and ``cache_hits`` taken by this owner, its
  ``invalidations`` by reason, and ``fused_steps`` (``compiled_step``
  calls), all in ``core/plan.py``.
- ``checkpoint`` counts ``saves``, ``loads``, ``pruned_steps``,
  ``auto_snapshots`` and ``refused`` (a synced state, or one whose
  accumulation an in-flight round holds), bumped by ``core/checkpoint.py``.
- ``health`` counts typed sync failures by class and the degradations,
  bumped by the ``on_error`` ladders of ``Metric`` and ``MetricCollection``.
- :data:`PROCESS` holds the process-wide facts: ``watchdog_fired`` and
  ``watchdog_margin_s`` (``parallel/health.py``), and the channel and quorum
  counters (``channel_suspect_latched``, ``channel_resets``,
  ``channel_readmits``, ``membership_transitions``, ``quorum_shrinks``,
  ``quorum_readmits``, ``suspect_episode_s``) and ``adaptive_timeout_s``
  (``parallel/resilience.py``).

``telemetry(delta=True)`` gives the numeric change since the previous delta
call; :func:`telemetry_jsonl` and :func:`telemetry_prometheus` encode a
snapshot for log shippers and scrapers. Nothing here reads a device.
"""
import json
import threading
from typing import Any, Dict, List, Optional

__all__ = [
    "TELEMETRY_SCHEMA",
    "PROCESS",
    "StatsRegistry",
    "add_process",
    "bump_process",
    "process_snapshot",
    "registry_of",
    "set_process",
    "telemetry_jsonl",
    "telemetry_prometheus",
]

#: Schema identifier stamped into every snapshot (the JAX package's).
TELEMETRY_SCHEMA = "metrics_tpu.telemetry.v1"

#: The domains of a snapshot and their counter defaults.
DOMAIN_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "compile": {
        "traces": 0,
        "dispatches": 0,
        "cache_hits": 0,
        "steps_seen": 0,
        "fallback": None,
    },
    "sync": {
        "launched": 0,
        "resolved": 0,
        "stale_resolves": 0,
        "degraded": 0,
        "cancelled": 0,
        "served_local": 0,
        "gather_s": 0.0,
        "resolve_wait_s": 0.0,
        "overlap_saved_s": 0.0,
        "intra_tier_bytes": 0,
        "inter_tier_bytes": 0,
        "inter_tier_bytes_saved": 0,
    },
    "checkpoint": {
        "saves": 0,
        "loads": 0,
        "pruned_steps": 0,
        "refused": 0,
        "auto_snapshots": 0,
    },
    "health": {
        "sync_failures": 0,
        "degraded": 0,
        "errors": {},  # SyncError class name -> count
    },
    "plan": {
        "builds": 0,
        "cache_hits": 0,
        "invalidations": 0,
        "invalidate_reasons": {},  # invalidation reason -> count
        "fused_steps": 0,
    },
}

#: Process-wide counters and gauges, snapshotted under the ``process`` key
#: of every ``telemetry()``. ``watchdog_margin_s`` is the last observed
#: headroom of a guarded collective (timeout minus its time).
PROCESS: Dict[str, Any] = {
    "watchdog_fired": 0,
    "channel_suspect_latched": 0,
    "channel_resets": 0,
    "channel_readmits": 0,
    "membership_transitions": 0,
    "quorum_shrinks": 0,
    "quorum_readmits": 0,
    "suspect_episode_s": 0.0,
    "watchdog_margin_s": 0.0,
    "adaptive_timeout_s": 0.0,
}
_PROCESS_LOCK = threading.Lock()


def bump_process(key: str, by: int = 1) -> None:
    with _PROCESS_LOCK:
        PROCESS[key] = PROCESS.get(key, 0) + by


def add_process(key: str, by: float) -> None:
    """Accumulate a float process gauge."""
    with _PROCESS_LOCK:
        PROCESS[key] = PROCESS.get(key, 0.0) + float(by)


def set_process(key: str, value: float) -> None:
    """Set a last-observed process gauge (the watchdog margin)."""
    with _PROCESS_LOCK:
        PROCESS[key] = value


def process_snapshot() -> Dict[str, Any]:
    """The process-wide facts, with the live channel-suspect latch."""
    from metrics_tpu_torch.parallel.health import channel_is_suspect

    with _PROCESS_LOCK:
        snap: Dict[str, Any] = dict(PROCESS)
    snap["channel_suspect"] = bool(channel_is_suspect())
    return snap


def _deep_copy_counters(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (dict(v) if isinstance(v, dict) else v) for k, v in d.items()}


def _numeric_delta(now: Any, before: Any) -> Any:
    """Recursive numeric difference; other leaves keep their current value."""
    if isinstance(now, dict):
        before = before if isinstance(before, dict) else {}
        return {k: _numeric_delta(v, before.get(k)) for k, v in now.items()}
    if isinstance(now, bool) or not isinstance(now, (int, float)):
        return now
    prev = before if isinstance(before, (int, float)) and not isinstance(before, bool) else 0
    return now - prev


class StatsRegistry:
    """Counter storage of one ``Metric`` or ``MetricCollection``.

    Domains are plain dicts (picklable, deep-copied with their owner);
    counting sites mutate the dict :meth:`domain` returns in place.
    """

    __slots__ = ("label", "_domains", "_last")

    def __init__(self, label: str) -> None:
        self.label = label
        self._domains: Dict[str, Dict[str, Any]] = {}
        self._last: Optional[Dict[str, Any]] = None

    def domain(self, name: str) -> Dict[str, Any]:
        """The live counter dict of ``name``, made from the defaults at first
        use."""
        d = self._domains.get(name)
        if d is None:
            d = _deep_copy_counters(DOMAIN_DEFAULTS.get(name, {}))
            self._domains[name] = d
        return d

    def inc(self, name: str, key: str, by: float = 1) -> None:
        d = self.domain(name)
        d[key] = d.get(key, 0) + by

    def count_error(self, err: BaseException, degraded: bool) -> None:
        """The health-domain bump of every sync-failure path."""
        h = self.domain("health")
        h["sync_failures"] += 1
        errors = h.setdefault("errors", {})
        cls = type(err).__name__
        errors[cls] = errors.get(cls, 0) + 1
        if degraded:
            h["degraded"] += 1

    def snapshot(self, extra: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict[str, Any]:
        """The full snapshot of this instance; ``extra`` splices in domains
        kept elsewhere (the ``compile_stats()`` view)."""
        snap: Dict[str, Any] = {"schema": TELEMETRY_SCHEMA, "label": self.label}
        domains = dict(extra or {})
        for name in DOMAIN_DEFAULTS:
            if name not in domains:
                domains[name] = self.domain(name)
        for name, counters in domains.items():
            snap[name] = _deep_copy_counters(counters)
        snap["process"] = process_snapshot()
        return snap

    def delta(self, extra: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict[str, Any]:
        """Numeric change since the previous ``delta()`` (the first deltas
        against zero); labels, fallback reasons and the live suspect flag
        carry their current value."""
        now = self.snapshot(extra)
        before = self._last or {}
        self._last = now
        out = {k: _numeric_delta(v, before.get(k)) for k, v in now.items()}
        out["schema"] = TELEMETRY_SCHEMA
        out["label"] = self.label
        return out

    def __deepcopy__(self, memo: dict) -> "StatsRegistry":
        new = StatsRegistry(self.label)
        new._domains = {k: _deep_copy_counters(v) for k, v in self._domains.items()}
        return new

    def with_fresh_domain(self, name: str) -> "StatsRegistry":
        """A copy whose ``name`` domain starts again from its defaults (a
        copied metric's ``compile`` counters describe the copy alone)."""
        new = self.__deepcopy__({})
        new._domains.pop(name, None)
        return new


def registry_of(obj: Any) -> StatsRegistry:
    """The registry of ``obj`` (a ``Metric`` or ``MetricCollection``), made at
    first use and kept outside ``nn.Module``'s attribute machinery."""
    reg = obj.__dict__.get("_telemetry")
    if reg is None:
        reg = StatsRegistry(type(obj).__name__)
        object.__setattr__(obj, "_telemetry", reg)
    return reg


# ---------------------------------------------------------------------------
# export encoders
# ---------------------------------------------------------------------------


def _flatten(prefix: str, value: Any, out: Dict[str, Any]) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}_{k}" if prefix else str(k), v, out)
    else:
        out[prefix] = value


def _each_block(snapshot: Dict[str, Any]) -> List[tuple]:
    """``(snapshot, member key or None)`` for a metric's snapshot, or for a
    collection's and each of its members'."""
    if "collection" in snapshot and "members" in snapshot:
        return [(snapshot["collection"], None)] + [(s, k) for k, s in snapshot["members"].items()]
    return [(snapshot, None)]


def telemetry_jsonl(snapshot: Dict[str, Any]) -> str:
    """One JSON line per domain (a collection's members each with their own
    lines, tagged ``member``)."""
    lines: List[str] = []
    for snap, member in _each_block(snapshot):
        for domain, counters in snap.items():
            if domain in ("schema", "label") or not isinstance(counters, dict):
                continue
            row: Dict[str, Any] = {
                "schema": snap.get("schema", TELEMETRY_SCHEMA),
                "label": snap.get("label", ""),
                "domain": domain,
            }
            if member is not None:
                row["member"] = member
            row.update(counters)
            lines.append(json.dumps(row, sort_keys=True, default=str))
    return "\n".join(lines)


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def telemetry_prometheus(snapshot: Dict[str, Any]) -> str:
    """Prometheus text exposition: numeric counters as
    ``metrics_tpu_<domain>_<counter>{label="..."}`` samples (``member="..."``
    for collection members), booleans as 0/1 gauges; strings are left to the
    JSON-lines form."""
    samples: List[str] = []
    typed: set = set()
    for snap, member in _each_block(snapshot):
        label = _prom_escape(str(snap.get("label", "")))
        for domain, counters in snap.items():
            if domain in ("schema", "label") or not isinstance(counters, dict):
                continue
            flat: Dict[str, Any] = {}
            _flatten("", counters, flat)
            for key, value in sorted(flat.items()):
                if isinstance(value, bool):
                    value = int(value)
                if not isinstance(value, (int, float)):
                    continue
                name = f"metrics_tpu_{domain}_{key}".replace("-", "_").replace(".", "_")
                if name not in typed:
                    typed.add(name)
                    samples.append(f"# TYPE {name} {'gauge' if domain == 'process' else 'counter'}")
                tags = f'label="{label}"'
                if member is not None:
                    tags += f',member="{_prom_escape(member)}"'
                samples.append(f"{name}{{{tags}}} {value}")
    return "\n".join(samples) + "\n"
