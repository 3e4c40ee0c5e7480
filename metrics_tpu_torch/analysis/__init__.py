"""metricslint for the port — static contract checker for metric classes
and collective schedules (counterpart of ``metrics_tpu/analysis``,
retargeted at torch).

The compiled hot path, the compute-group planner and the health-checked
sync rest on contracts the runtime can otherwise only enforce late:
``update()`` must mutate only declared state (tensors are mutable, so
in-place writes count), latches must be declared, identity overrides must
be re-declared, hot paths must not read the device back to the host, and
every rank must emit collectives in a deterministic, data-independent
order. This package moves those contracts to class-definition time and CI:

- :mod:`metric_pass` — per-class AST rules (mutation discipline, host-sync
  antipatterns, declaration hygiene);
- :mod:`schedule_pass` — rank/data-independent collective emission order
  over the ``torch.distributed`` call graph;
- :mod:`runtime` — the live-class bridge: ``core/compiled.py``'s
  eligibility probe consults static verdicts (skip the FakeTensorMode probe
  for verified-clean classes, definition-time diagnostics naming the
  offending attribute/line for verified-dirty ones), and
  ``core/collections.py`` screens compute-group candidates against the
  static report;
- CLI: ``python -m metrics_tpu_torch.analysis [paths]`` — nonzero exit on
  findings, ``# metricslint: disable=<rule>`` suppressions.

The AST passes import neither torch nor jax and execute no metric code —
they run on any machine and any source tree, including deliberately-broken
fixture files.
"""
import ast
import os
from typing import Iterable, List, Sequence, Tuple  # noqa: F401 - the JAX package's import surface

from metrics_tpu_torch.analysis.metric_pass import Universe, run_metric_pass
from metrics_tpu_torch.analysis.report import RULES, Finding, filter_findings
from metrics_tpu_torch.analysis.schedule_pass import run_schedule_pass

__all__ = [
    "RULES",
    "Finding",
    "analyze_paths",
    "analyze_source",
    "iter_python_files",
]


def iter_python_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into a sorted, deterministic .py file list."""
    out: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
        else:
            out.append(path)
    return out


def analyze_source(
    source: str, path: str = "<string>", schedule: bool = True
) -> List[Finding]:
    """Run both passes over one module's source; suppressions applied."""
    tree = ast.parse(source, filename=path)
    universe = Universe()
    infos = universe.add_module(tree, path)
    findings = run_metric_pass(universe, infos)
    if schedule:
        findings.extend(run_schedule_pass(tree, path))
    return sorted(
        filter_findings(findings, source), key=lambda f: (f.path, f.line, f.col, f.rule)
    )


def analyze_paths(
    paths: Sequence[str], schedule: bool = True
) -> Tuple[List[Finding], List[str]]:
    """Analyze every .py file under ``paths``.

    The metric pass resolves inheritance across the whole file set (one
    shared :class:`Universe`), so e.g. ``Accuracy`` in one file sees the
    states its ``StatScores`` base declares in another. Returns
    ``(findings, errors)`` — ``errors`` are unreadable/unparsable files
    (reported, and the CLI exits nonzero on them, but they never abort the
    run).
    """
    files = iter_python_files(paths)
    universe = Universe()
    parsed: List[Tuple[str, str, ast.Module]] = []
    errors: List[str] = []
    file_infos = {}
    for path in files:
        try:
            with open(path, "r") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as err:
            errors.append(f"{path}: {type(err).__name__}: {err}")
            continue
        parsed.append((path, source, tree))
        file_infos[path] = universe.add_module(tree, path)
    findings: List[Finding] = []
    for path, source, tree in parsed:
        per_file = run_metric_pass(universe, file_infos[path])
        if schedule:
            per_file.extend(run_schedule_pass(tree, path))
        findings.extend(filter_findings(per_file, source))
    return (
        sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)),
        errors,
    )
