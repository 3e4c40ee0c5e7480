"""Findings, rule registry and suppression handling for metricslint
(counterpart of ``metrics_tpu/analysis/report.py``, framework-free, so the
same code).

The checker's contract with its consumers is deliberately small: every rule
violation is one :class:`Finding` (rule id, location, message, and — when the
rule is about an attribute — the attribute name), a file's findings come back
as a plain list, and ``# metricslint: disable=<rule>`` comments filter them
out *before* they are reported. Keeping suppressions in this layer means the
AST passes never need to know about them, and the runtime consumers
(``core/compiled.py`` probe pre-classification, the compute-group planner)
see exactly what the CLI would print.

Suppression syntax:

- on the offending line or the line directly above it::

      self.seen = []  # metricslint: disable=undeclared-state

- on a ``def``/``class`` line, covering the whole function/class body::

      def update(self, preds):  # metricslint: disable=host-sync-in-update

- ``disable=all`` (or a comma list ``disable=rule-a,rule-b``) widens the
  scope of either form.
"""
import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

#: rule id -> one-line description (the CLI's --list-rules catalog), the JAX
#: package's catalog as it is: ``asymmetric-schedule-decision``, which the
#: schedule pass emits, is not listed there either
RULES: Dict[str, str] = {
    # ---- metric-class pass (metric_pass.py) -----------------------------
    "undeclared-state": (
        "update()/compute() mutates a self attribute that no reachable "
        "add_state() declares (includes in-place container mutation)"
    ),
    "unshared-latch": (
        "update() of a compute-group-eligible class (declares update_identity) "
        "mutates a non-state attribute missing from _group_shared_attrs"
    ),
    "host-sync-in-update": (
        "update()/compute() forces a host sync on a traced value "
        "(float()/int()/bool(), .item(), np.asarray/np.array, jax.device_get)"
    ),
    "update-identity-redeclare": (
        "class overrides update() without re-declaring update_identity(); the "
        "inherited group key is silently dropped at runtime"
    ),
    "state-default": (
        "add_state() declaration problem detectable statically: non-empty list "
        "default, scalar default with dist_reduce_fx='cat', growing-list "
        "default with a reduce-style fx, invalid fx literal, duplicate name"
    ),
    # ---- collective-schedule pass (schedule_pass.py) --------------------
    "rank-dependent-collective": (
        "a collective is emitted (or skipped) under a branch that depends on "
        "jax.process_index() — the per-rank collective schedules diverge"
    ),
    "data-dependent-collective": (
        "a collective is emitted (or skipped) under a branch that depends on "
        "per-rank local data that no prior collective made symmetric"
    ),
    "collective-in-handler": (
        "a collective is emitted inside an except/finally block — only "
        "symmetric failures may be followed by more collectives"
    ),
    "nondeterministic-collective-order": (
        "a collective is emitted while iterating an unordered set — emission "
        "order must be deterministic and identical on every rank"
    ),
    "guarded-telemetry-emit": (
        "an observability journal emission (record()) sits under a rank- or "
        "per-rank-data-dependent branch — ranks would record different event "
        "journals, breaking cross-rank trace correlation"
    ),
}

_SUPPRESS_RE = re.compile(r"#\s*metricslint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    #: attribute the finding is about (mutation rules), for runtime consumers
    attr: Optional[str] = None
    #: dotted owner, e.g. "Accuracy.update", for grouping/diagnostics
    owner: Optional[str] = None

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"


@dataclass
class Suppressions:
    """Per-file suppression map: line -> set of rule ids ('all' wildcard)."""

    by_line: Dict[int, Set[str]] = field(default_factory=dict)
    #: (start, end, rules) spans from def/class-line suppressions
    spans: List[Tuple[int, int, Set[str]]] = field(default_factory=list)

    def suppressed(self, rule: str, line: int) -> bool:
        for probe in (line, line - 1):
            rules = self.by_line.get(probe)
            if rules and ("all" in rules or rule in rules):
                return True
        for start, end, rules in self.spans:
            if start <= line <= end and ("all" in rules or rule in rules):
                return True
        return False


def _def_spans(source: str, tree=None) -> List[Tuple[int, int]]:
    """(start, end) line spans of every def/class in the file (``tree``: its
    AST, when the caller parsed it already)."""
    import ast

    spans: List[Tuple[int, int]] = []
    if tree is None:
        try:
            tree = ast.parse(source)
        except SyntaxError:
            return spans
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            spans.append((node.lineno, node.end_lineno or node.lineno))
    return spans


def parse_suppressions(source: str, tree=None) -> Suppressions:
    """Collect ``# metricslint: disable=...`` comments via the tokenizer (so
    a ``disable=`` inside a string literal never counts). ``tree``, the
    source's AST if the caller has it, saves a second parse."""
    sup = Suppressions()
    per_line: Dict[int, Set[str]] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return sup
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        per_line.setdefault(tok.start[0], set()).update(rules)
    sup.by_line = per_line
    if per_line:
        for start, end in _def_spans(source, tree):
            rules = per_line.get(start)
            if rules:
                sup.spans.append((start, end, set(rules)))
    return sup


def filter_findings(findings: List[Finding], source: str) -> List[Finding]:
    """Drop findings a ``# metricslint: disable=...`` comment covers."""
    sup = parse_suppressions(source)
    return [f for f in findings if not sup.suppressed(f.rule, f.line)]
