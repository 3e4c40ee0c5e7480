"""Static-report consumers inside the runtime — probe pre-classification
and compute-group declaration validation (counterpart of
``metrics_tpu/analysis/runtime.py``).

``core/compiled.py``'s eligibility probe (``probe_traceable``: a
FakeTensorMode dry run + instance-``__dict__`` diffing) exists to answer two
questions before any CUDA graph is captured: *is update capturable?* and
*does update latch undeclared instance attributes?* For most shipped metric
classes both answers are
static properties of the source. This module evaluates the metric-class
pass against a **live** class — declared states come from the instance's
runtime ``_defaults`` (exact, even for dynamically-named states the AST
cannot resolve) while the write/host-sync facts come from the AST of the
class's actual MRO — and caches one verdict per class:

- ``CLEAN``: every attribute written by update (helpers included) is a
  declared state / shared latch / runtime-bookkeeping attr, the scan is
  fully resolved, and no host-sync antipattern (the usual cause of a
  failed capture) appears. The probe may be skipped: the compiled dispatch
  produces results bit-identical to the probed path. A host read the
  analysis cannot see (one inside a module-level helper) is then found
  inside the CUDA graph capture, which raises; ``core/compiled.py``'s
  ``CaptureError`` path marks the fallback, nothing ran, the states are
  intact and the class runs eagerly from then on.
- ``DIRTY``: the scan is fully resolved and update writes an undeclared
  attribute — the probe's conclusion, known at class-definition time. The
  dispatcher can mark the fallback immediately, naming the attribute and
  source line instead of the generic probe message.
- ``UNKNOWN``: anything less than full resolution (dynamic writes,
  unresolvable helpers, source unavailable). The runtime probe keeps the
  last word, exactly as before.

``METRICS_TPU_ANALYSIS_PRECLASSIFY=0`` turns consultation off process-wide
(every class probes — the escape hatch the equality tests use to assert
bit-identical results).

Sources are resolved through ``inspect.getsourcefile``: a class defined in a
REPL or an exec'd string stays "unknown". Nothing here imports torch.
"""
import ast
import inspect
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from metrics_tpu_torch.analysis import metric_pass
from metrics_tpu_torch.analysis.metric_pass import (
    RUNTIME_EXEMPT_ATTRS,
    AttrWrite,
    BodyScan,
    ClassInfo,
    Universe,
    harvest_classes,
    scan_entry,
)
from metrics_tpu_torch.analysis.report import _SUPPRESS_RE, Finding, Suppressions, parse_suppressions

#: Env escape hatch: 0/false/off disables static probe pre-classification
#: (and the planner's static-hazard screen) process-wide.
PRECLASSIFY_ENV = "METRICS_TPU_ANALYSIS_PRECLASSIFY"


def preclassify_enabled() -> bool:
    return os.environ.get(PRECLASSIFY_ENV, "1").strip().lower() not in (
        "0", "false", "off", "no",
    )


@dataclass
class ClassVerdict:
    """Cached static analysis of one live class's update/compute/merge bodies.

    Kinds: ``"update"`` (compiled update captures ``pure_update``),
    ``"compute"`` (compiled forward adds the batch-local ``pure_compute``)
    and ``"merge"`` (compiled forward also captures ``merge_states``).
    """

    resolved_update: bool = False
    resolved_compute: bool = False
    resolved_merge: bool = False
    #: every self-attr write reachable from update / compute, with locations
    update_writes: List[AttrWrite] = field(default_factory=list)
    compute_writes: List[AttrWrite] = field(default_factory=list)
    #: self-attr writes reachable from merge_states: the compiled forward
    #: runs the merge functionally on state dicts, so ANY instance write
    #: there (declared or not) would be skipped — demotes to "unknown"
    merge_writes: List[AttrWrite] = field(default_factory=list)
    #: per-kind: self attrs (or aliases) passed into non-pure callees —
    #: demote when the live value is a mutable container
    leaked: Dict[str, List[str]] = field(default_factory=dict)
    #: host-sync findings from the update scan and the merge_states scan
    host_syncs: List[Finding] = field(default_factory=list)
    merge_host_syncs: List[Finding] = field(default_factory=list)
    #: per-kind demotion signals: device-value branches (legal eager, a host
    #: read under capture) and compute-side host syncs — never "dirty"
    #: (eager semantics are fine), but the probe must keep the last word, so
    #: "clean" demotes to "unknown"
    demotions: Dict[str, int] = field(default_factory=dict)
    path: str = ""

    def undeclared_writes(
        self, declared: Set[str], kinds: Tuple[str, ...] = ("update",)
    ) -> List[AttrWrite]:
        out: List[AttrWrite] = []
        seen: Set[Tuple[str, int]] = set()
        for kind in kinds:
            if kind == "merge":
                continue  # merge_states is scanned for host syncs only
            for w in self.update_writes if kind == "update" else self.compute_writes:
                if w.attr in declared or w.attr in RUNTIME_EXEMPT_ATTRS or w.attr.startswith("__"):
                    continue
                key = (w.attr, w.line)
                if key not in seen:
                    seen.add(key)
                    out.append(w)
        return out

    def sync_findings(self, kinds: Tuple[str, ...]) -> List[Finding]:
        out: List[Finding] = []
        if "update" in kinds:
            out.extend(self.host_syncs)
        if "merge" in kinds:
            out.extend(self.merge_host_syncs)
        return out

    def resolved(self, kinds: Tuple[str, ...]) -> bool:
        by_kind = {
            "update": self.resolved_update,
            "compute": self.resolved_compute,
            "merge": self.resolved_merge,
        }
        return all(by_kind[k] for k in kinds)


_verdicts: Dict[type, Optional[ClassVerdict]] = {}
_module_universes: Dict[Tuple[str, ...], Tuple[Universe, Dict[Tuple[str, str], ClassInfo]]] = {}
#: one parse (and one class harvest) of each source file, shared by every
#: MRO that reaches it (``core/metric.py`` is on all of them)
_modules: Dict[str, Optional[Tuple[ast.Module, List[ClassInfo]]]] = {}
#: one suppression map per source file
_suppression_maps: Dict[str, Optional[Suppressions]] = {}


def clear_cache() -> None:
    """Test hook: forget every cached verdict and parsed module."""
    _verdicts.clear()
    _module_universes.clear()
    _modules.clear()
    _suppression_maps.clear()
    metric_pass._FUNCTION_SCANS.clear()


def _parsed_module(path: str):
    if path not in _modules:
        try:
            with open(path, "r") as fh:
                tree = ast.parse(fh.read())
        except (OSError, SyntaxError):
            _modules[path] = None
        else:
            _modules[path] = (tree, harvest_classes(tree, path))
    return _modules[path]


def _mro_universe(cls: type):
    """Parse the modules of every class on ``cls``'s MRO (the runtime MRO,
    not the textual approximation) into one Universe, and index each class
    by (source path, qualname)."""
    paths: List[str] = []
    for c in cls.__mro__:
        if c is object:
            continue
        try:
            path = inspect.getsourcefile(c)
        except TypeError:
            return None
        if path is None:
            return None
        if path not in paths:
            paths.append(path)
    key = tuple(paths)
    cached = _module_universes.get(key)
    if cached is not None:
        return cached
    universe = Universe()
    index: Dict[Tuple[str, str], ClassInfo] = {}
    for path in paths:
        parsed = _parsed_module(path)
        if parsed is None:
            return None
        for ci in universe.add_module(parsed[0], path, infos=parsed[1]):
            index[(path, ci.qualname)] = ci
    _module_universes[key] = (universe, index)
    return universe, index


def _class_info_for(cls: type, universe_index) -> Optional[ClassInfo]:
    universe, index = universe_index
    try:
        path = inspect.getsourcefile(cls)
    except TypeError:
        return None
    if path is None:
        return None
    return index.get((path, cls.__qualname__))


def class_verdict(cls: type) -> Optional[ClassVerdict]:
    """The cached static verdict for ``cls`` (None = source unavailable)."""
    if cls in _verdicts:
        return _verdicts[cls]
    verdict = _build_verdict(cls)
    _verdicts[cls] = verdict
    return verdict


def _build_verdict(cls: type) -> Optional[ClassVerdict]:
    uni = _mro_universe(cls)
    if uni is None:
        return None
    universe, _ = uni
    ci = _class_info_for(cls, uni)
    if ci is None:
        return None
    v = ClassVerdict(path=ci.path)
    # chain state names feed only the host-sync taint seeds; the declared
    # set the caller checks writes against comes from the live instance
    state_names: Set[str] = set()
    for c in universe.chain(ci):
        state_names |= c.state_names
    sources: Dict[str, str] = {}
    for kind in ("update", "compute", "merge_states"):
        scan = scan_entry(universe, ci, kind, state_names)
        if scan is None:
            # no visible definition anywhere on the MRO sources: stay unknown
            continue
        suppressed = _apply_suppressions(scan, sources)
        # conservative rescan: every parameter treated as a device value, so
        # a host sync / value branch on an UNANNOTATED tensor input demotes
        # "clean" to "unknown" (the probe then decides, as before)
        cons = scan_entry(universe, ci, kind, state_names, seed_all_params=True)
        branches = [
            vb for vb in cons.value_branches
            if not _branch_suppressed(vb, sources)
        ]
        demote = len(branches) + len(_apply_suppressions(cons, sources).host_syncs)
        if kind == "update":
            v.resolved_update = scan.resolved
            v.update_writes = suppressed.writes
            v.host_syncs = suppressed.host_syncs
            # annotation-confirmed syncs are DIRTY; conservative extras demote
            v.demotions["update"] = demote - len(suppressed.host_syncs)
            v.leaked["update"] = list(scan.leaked)
        elif kind == "compute":
            v.resolved_compute = scan.resolved
            v.compute_writes = suppressed.writes
            v.demotions["compute"] = demote
            v.leaked["compute"] = list(scan.leaked)
        else:
            v.resolved_merge = scan.resolved
            v.merge_host_syncs = suppressed.host_syncs
            v.merge_writes = [
                w for w in scan.writes
                if w.attr not in RUNTIME_EXEMPT_ATTRS and not w.attr.startswith("__")
            ]
            v.demotions["merge"] = demote - len(suppressed.host_syncs)
            v.leaked["merge"] = list(scan.leaked)
    return v


def _apply_suppressions(scan: BodyScan, sources: Dict[str, str]) -> BodyScan:
    """Honor ``# metricslint: disable=...`` comments for runtime consumers
    too: a suppressed finding must not flip a class to DIRTY (the CLI and
    the probe must agree on what counts)."""
    out = BodyScan(resolved=scan.resolved)
    for w in scan.writes:
        # writes carry no rule yet — they become undeclared-state /
        # unshared-latch depending on the consumer; honor either suppression
        sup = _suppressions(w.path, sources) if w.path else None
        if sup is not None:
            if sup.suppressed("undeclared-state", w.line) or sup.suppressed("unshared-latch", w.line):
                continue
        out.writes.append(w)
    if scan.host_syncs:
        by_path: Dict[str, List[Finding]] = {}
        for f in scan.host_syncs:
            by_path.setdefault(f.path, []).append(f)
        for path, fs in by_path.items():
            sup = _suppressions(path, sources)
            out.host_syncs.extend(fs if sup is None else [f for f in fs if not sup.suppressed(f.rule, f.line)])
    return out


def _branch_suppressed(vb, sources: Dict[str, str]) -> bool:
    """A device-value branch on a line carrying a host-sync suppression is
    waived (the host-bool overflow flag in ``Metric.merge_states`` is the
    canonical case: the comment vouches the branch never reads the device),
    keeping the CLI and the runtime verdict in agreement."""
    line, _owner, path = vb
    sup = _suppressions(path, sources) if path else None
    return sup is not None and sup.suppressed("host-sync-in-update", line)


def _suppressions(path: str, sources: Dict[str, str]) -> Optional[Suppressions]:
    """``parse_suppressions`` of one file, parsed once (``filter_findings``
    is the same filter)."""
    if path not in _suppression_maps:
        src = _read_source(path, sources)
        if src is None:
            _suppression_maps[path] = None
        elif _SUPPRESS_RE.search(src) is None:
            # no comment can suppress anything here: skip the tokenizer
            _suppression_maps[path] = Suppressions()
        else:
            parsed = _parsed_module(path)
            _suppression_maps[path] = parse_suppressions(src, None if parsed is None else parsed[0])
    return _suppression_maps[path]


def _read_source(path: str, sources: Dict[str, str]) -> Optional[str]:
    if path not in sources:
        try:
            with open(path, "r") as fh:
                sources[path] = fh.read()
        except OSError:
            return None
    return sources[path]


# ---------------------------------------------------------------------------
# probe pre-classification (core/compiled.py / core/metric.py)
# ---------------------------------------------------------------------------

def static_probe_verdict(metric, kinds: Tuple[str, ...]) -> Tuple[str, Optional[str]]:
    """Pre-classify one metric instance for the compiled-eligibility probe.

    Returns ``(verdict, detail)`` where verdict is:

    - ``"clean"`` — statically verified: skip the FakeTensorMode probe.
    - ``"dirty"`` — statically refuted: ``detail`` names the offending
      attribute(s) and source line(s); mark the fallback without probing.
    - ``"unknown"`` — run the probe, as before pre-classification existed.

    ``kinds`` is ``("update",)`` for compiled update and
    ``("update", "compute", "merge")`` for compiled forward (whose program
    also captures the batch-local compute and the ``merge_states`` fold).
    """
    if not preclassify_enabled():
        return "unknown", None
    cls = type(metric)
    v = class_verdict(cls)
    if v is None or not v.resolved(kinds):
        return "unknown", None
    declared = set(getattr(metric, "_defaults", ())) | set(
        getattr(cls, "_group_shared_attrs", ()) or ()
    )
    bad = v.undeclared_writes(declared, kinds)
    if bad:
        spots = ", ".join(
            f"self.{w.attr} ({_short(v.path)}:{w.line}, {w.owner})" for w in bad[:4]
        )
        return (
            "dirty",
            f"update mutates undeclared instance attribute(s): {spots} — "
            "statically flagged by metricslint (undeclared-state); declare the "
            "attr with add_state or list it in _group_shared_attrs",
        )
    syncs = v.sync_findings(kinds)
    if syncs:
        f = syncs[0]
        return (
            "dirty",
            f"the captured path forces a host sync on a device value "
            f"({_short(f.path)}:{f.line}, {f.owner}) — statically flagged by "
            "metricslint (host-sync-in-update); it would fail capture anyway",
        )
    if any(v.demotions.get(k, 0) for k in kinds):
        # a device-value python branch (or a compute-side host sync) is fine
        # eagerly but reads the device under capture — let the probe decide
        return "unknown", None
    if "merge" in kinds and v.merge_writes:
        # the compiled forward runs merge_states functionally on state
        # dicts: ANY instance write there (even to a declared state) would
        # be skipped by the replay — the probe must decide
        return "unknown", None
    for kind in kinds:
        for attr in v.leaked.get(kind, ()):
            if not _replay_safe(getattr(metric, attr, None)):
                # a mutable (or unknown-type) attr escaped into a callee we
                # cannot see through — an in-place mutation could hide there
                return "unknown", None
    return "clean", None


def _replay_safe(value) -> bool:
    """Can a callee that receives ``value`` change it in a way a graph
    replay would skip? Not for immutable Python values, a ``torch.device``
    or ``torch.dtype``, nor for a tensor: an in-place write into a tensor's
    storage is a kernel the graph captured, and every replay repeats it.
    A list, dict or object can be rebound or grown on the host, which no
    replay repeats."""
    if isinstance(value, (str, int, float, bool, bytes, tuple, frozenset, type(None))):
        return True
    if type(value).__module__ == "torch" and type(value).__name__ in ("device", "dtype"):
        return True
    return hasattr(value, "dtype") and hasattr(value, "shape")


def static_probe_verdict_many(pairs) -> Tuple[str, Optional[str]]:
    """Aggregate :func:`static_probe_verdict` over ``(metric, kinds)`` pairs:
    ``dirty`` dominates (first detail), then ``unknown``, else ``clean``."""
    saw_unknown = False
    saw_any = False
    for metric, kinds in pairs:
        saw_any = True
        verdict, detail = static_probe_verdict(metric, kinds)
        if verdict == "dirty":
            return "dirty", detail
        saw_unknown = saw_unknown or verdict == "unknown"
    if not saw_any or saw_unknown:
        return "unknown", None
    return "clean", None


def _short(path: str) -> str:
    parts = path.split(os.sep)
    return os.sep.join(parts[-2:]) if len(parts) >= 2 else path


# ---------------------------------------------------------------------------
# compute-group declaration validation (core/collections.py)
# ---------------------------------------------------------------------------

def grouping_hazards(metric) -> List[str]:
    """Human-readable reasons this metric's class must not join a compute
    group, from the static report: update writes an attribute that is
    neither an ``add_state`` state nor listed in ``_group_shared_attrs``,
    so a group dispatch would not propagate it to siblings. Empty when the
    class is clean or the analysis could not fully resolve update (the
    runtime contract — declared identity — is then trusted as before)."""
    if not preclassify_enabled():
        return []
    cls = type(metric)
    v = class_verdict(cls)
    if v is None or not v.resolved(("update",)):
        return []
    declared = set(getattr(metric, "_defaults", ())) | set(
        getattr(cls, "_group_shared_attrs", ()) or ()
    )
    return [
        f"update writes self.{w.attr} ({_short(v.path)}:{w.line}, {w.owner}), "
        "which is neither an add_state state nor listed in _group_shared_attrs"
        for w in v.undeclared_writes(declared, ("update",))
    ]
