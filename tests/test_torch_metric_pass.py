"""metricslint for the port, metric-class pass: the JAX suite
(``tests/analysis/test_metric_pass.py``) case for case over the torch twins of
its fixtures, the torch-only rules (in-place writes, the torch host syncs),
the repairs C.23/C.24, and parity with the JAX package's linter:

- (a) ``parse_suppressions``/``filter_findings`` agree on every source file
  of both packages and both fixture folders;
- (b) each JAX fixture and its twin give the same multiset of
  ``(rule, line, attr, owner)``.
"""
import io
import tokenize
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import metrics_tpu.analysis.report as jax_report
import metrics_tpu_torch.analysis.report as port_report
from metrics_tpu.analysis import analyze_paths as jax_analyze_paths
from metrics_tpu_torch.analysis import analyze_paths, analyze_source
from metrics_tpu_torch.analysis.metric_pass import RUNTIME_EXEMPT_ATTRS, Universe, scan_entry

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_analysis_fixtures"
JAX_FIXTURES = ROOT / "tests" / "analysis" / "fixtures"
TWINS = sorted(p.name for p in JAX_FIXTURES.glob("*.py"))


def fixture(name: str) -> str:
    return str(FIXTURES / name)


def rules_of(findings):
    return {f.rule for f in findings}


def analyze_fixture(name: str):
    findings, errors = analyze_paths([fixture(name)])
    assert not errors
    return findings


# ---------------------------------------------------------------------------
# fixture files: each violating file trips exactly its rules, clean trips none
# ---------------------------------------------------------------------------

def test_undeclared_state_fixture_variants():
    findings = analyze_fixture("violating_undeclared_state.py")
    assert rules_of(findings) == {"undeclared-state"}
    attrs = {f.attr for f in findings}
    assert attrs == {"seen", "shapes", "by_kind", "calls", "last_batch", "cached"}
    assert not any(f.attr in ("total", "rows") for f in findings)


def test_host_sync_fixture_variants():
    findings = analyze_fixture("violating_host_sync.py")
    assert rules_of(findings) == {"host-sync-in-update"}
    msgs = " | ".join(f.message for f in findings)
    # the JAX fixture's jax.device_get line is .cpu() in the twin
    for needle in ("float()", ".item()", "np.asarray", ".cpu()", "int()"):
        assert needle in msgs, f"missing variant: {needle}"


def test_hygiene_fixture_variants():
    findings = analyze_fixture("violating_hygiene.py")
    assert rules_of(findings) == {"update-identity-redeclare", "unshared-latch", "state-default"}
    joined = " | ".join(f.message for f in findings if f.rule == "state-default")
    for needle in ("EMPTY list", "'prod'", "growing list", "0-d default", "duplicate"):
        assert needle in joined, f"missing state-default variant: {needle}"
    latch = next(f for f in findings if f.rule == "unshared-latch")
    assert latch.attr == "num_classes"


def test_clean_fixture_has_no_findings():
    assert analyze_fixture("clean_metric.py") == []


def test_suppressed_fixture_has_no_findings():
    assert analyze_fixture("suppressed_metric.py") == []


def test_suppression_is_rule_specific():
    src = open(fixture("suppressed_metric.py")).read()
    bad = src.replace("# metricslint: disable=undeclared-state", "# metricslint: disable=state-default")
    assert "undeclared-state" in rules_of(analyze_source(bad, "suppressed_metric.py"))


# ---------------------------------------------------------------------------
# torch-only rules
# ---------------------------------------------------------------------------

def test_inplace_fixture_variants():
    findings = analyze_fixture("violating_inplace_state.py")
    assert rules_of(findings) == {"undeclared-state"}
    # add_, index_add_, an alias's zero_, out=, item assignment, .data
    assert sorted((f.owner, f.attr, f.line) for f in findings) == [
        ("InPlaceMethodLatch.update", "acc", 27),
        ("InPlaceMethodLatch.update", "hist", 25),
        ("InPlaceMethodLatch.update", "seen", 24),
        ("ItemAssignLatch.update", "last", 58),
        ("ItemAssignLatch.update", "last", 59),
        ("OutArgumentLatch.update", "scratch", 42),
    ]
    assert all("in place" in f.message for f in findings)


def test_dynamic_setattr_leaves_the_scan_unresolved():
    src = open(fixture("violating_inplace_state.py")).read()
    import ast

    universe = Universe()
    infos = {ci.name: ci for ci in universe.add_module(ast.parse(src), "f.py")}
    assert scan_entry(universe, infos["DynamicWriteStaysSilent"], "update", {"total"}).resolved is False
    assert scan_entry(universe, infos["InPlaceMethodLatch"], "update", {"total"}).resolved is True


def test_torch_host_sync_fixture_variants():
    findings = analyze_fixture("violating_torch_host_sync.py")
    assert rules_of(findings) == {"host-sync-in-update"}
    by_line = {f.line: f.message for f in findings}
    assert sorted(by_line) == [20, 21, 22, 23, 25, 40, 41, 42, 43, 44, 45]
    for needle in (".tolist()", ".numpy()", '.to("cpu")', "synchronize", "nonzero()", "unique()",
                   "masked_select()", "torch.where", "repeat_interleave"):
        assert any(needle in m for m in by_line.values()), needle


@pytest.mark.parametrize("default, fires", [
    ("torch.zeros(())", True), ("torch.tensor(0.0)", True), ("torch.zeros([])", True),
    ("torch.zeros(3)", False), ("[]", False),
])
def test_scalar_default_on_a_cat_state(default, fires):
    src = f'''
import torch

class M:
    def __init__(self):
        self.add_state("v", {default}, dist_reduce_fx="cat")
    def add_state(self, *a, **k):
        pass
    def update(self, x):
        self.v.append(x)
    def compute(self):
        return self.v
'''
    found = [f for f in analyze_source(src, "<snippet>") if "0-d default" in f.message]
    assert bool(found) is fires


# ---------------------------------------------------------------------------
# inline edge cases (the JAX suite's)
# ---------------------------------------------------------------------------

SNIPPET = '''
import torch

class M:
    def __init__(self):
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
    def add_state(self, *a, **k):
        pass
    def update(self, x):
        {body}
    def compute(self):
        return self.total
'''


def _one(body: str):
    return analyze_source(SNIPPET.format(body=body), "<snippet>")


def test_runtime_bookkeeping_attrs_are_exempt():
    assert _one("self._update_count = 3; self._compute_group = None; self.total = self.total + torch.sum(x)") == []


def test_setattr_with_constant_name_is_caught():
    findings = _one('setattr(self, "latch", 1); self.total = self.total + torch.sum(x)')
    assert [f.attr for f in findings] == ["latch"]
    findings = _one('nn.Module.__setattr__(self, "latch", 1); self.total = self.total + torch.sum(x)')
    assert [f.attr for f in findings] == ["latch"]


def test_dynamic_state_names_stay_silent():
    src = '''
import torch

class M:
    def __init__(self, keys):
        for k in keys:
            self.add_state(f"{k}_sum", torch.zeros(()), dist_reduce_fx="sum")
    def add_state(self, *a, **k):
        pass
    def update(self, x):
        self.anything = 1
    def compute(self):
        return 0
'''
    assert analyze_source(src, "<snippet>") == []


def test_conditional_alternative_declarations_are_not_duplicates():
    src = '''
import torch

class M:
    def __init__(self, samplewise):
        if samplewise:
            self.add_state("v", [], dist_reduce_fx="cat")
        else:
            self.add_state("v", torch.zeros(()), dist_reduce_fx="sum")
    def add_state(self, *a, **k):
        pass
    def update(self, x):
        self.v = self.v + torch.sum(x)
    def compute(self):
        return self.v
'''
    assert analyze_source(src, "<snippet>") == []


def test_cross_file_inheritance_resolves_states(tmp_path):
    (tmp_path / "base_mod.py").write_text('''
import torch

class Base:
    def __init__(self):
        for s in ("tp", "fp"):
            self.add_state(s, torch.zeros(()), dist_reduce_fx="sum")
    def add_state(self, *a, **k):
        pass
    def update(self, x):
        self.tp = self.tp + 1
    def compute(self):
        return self.tp
''')
    (tmp_path / "child_mod.py").write_text('''
from base_mod import Base

class Child(Base):
    def update(self, x):
        self.fp.add_(1)         # declared in the OTHER file's Base
        self.stray = 1          # finding
''')
    findings, errors = analyze_paths([str(tmp_path)])
    assert not errors
    assert [(f.rule, f.attr) for f in findings] == [("undeclared-state", "stray")]


def test_exempt_set_matches_runtime_probe():
    from metrics_tpu_torch.core.compiled import _PROBE_EXEMPT

    missing = set(_PROBE_EXEMPT) - set(RUNTIME_EXEMPT_ATTRS)
    assert not missing, f"RUNTIME_EXEMPT_ATTRS is missing {sorted(missing)}"


def test_shipped_package_is_clean():
    """The acceptance gate, as a test: the CLI contract over metrics_tpu_torch/."""
    findings, errors = analyze_paths([str(ROOT / "metrics_tpu_torch")])
    assert not errors
    assert findings == [], "\n".join(f.format() for f in findings)


# ---------------------------------------------------------------------------
# the repairs: C.23, C.24 (values against the JAX package)
# ---------------------------------------------------------------------------

def _file_suppressions(path: Path):
    return [t.string for t in tokenize.generate_tokens(io.StringIO(path.read_text()).readline)
            if t.type == tokenize.COMMENT and "metricslint: disable" in t.string]


def test_c23_calibration_error_writes_no_attribute_and_equals_the_reference():
    import jax.numpy as jnp

    import metrics_tpu as ref
    import metrics_tpu_torch as port

    path = ROOT / "metrics_tpu_torch" / "classification" / "calibration_error.py"
    assert analyze_paths([str(path)])[0] == [] and _file_suppressions(path) == []
    rng = np.random.RandomState(23)
    probs = rng.dirichlet(np.ones(4), 64).astype(np.float32)
    target = rng.randint(0, 4, 64)
    for norm in ("l1", "max"):
        m = port.CalibrationError(n_bins=10, norm=norm, device="cpu")
        m.update(torch.from_numpy(probs), torch.from_numpy(target))
        before = {k: v for k, v in m.__dict__.items() if k not in RUNTIME_EXEMPT_ATTRS}
        value = float(m.compute())
        after = {k: v for k, v in m.__dict__.items() if k not in RUNTIME_EXEMPT_ATTRS}
        assert after.keys() == before.keys() and all(after[k] is before[k] for k in before)
        r = ref.CalibrationError(n_bins=10, norm=norm)
        r.update(jnp.asarray(probs), jnp.asarray(target))
        assert value == pytest.approx(float(r.compute()), rel=1e-6, abs=1e-7)


def test_c24_bootstrapper_declares_its_key_latch():
    import metrics_tpu as ref
    import metrics_tpu_torch as port

    path = ROOT / "metrics_tpu_torch" / "wrappers" / "bootstrapping.py"
    assert analyze_paths([str(path)])[0] == [] and _file_suppressions(path) == []
    assert port.BootStrapper._group_shared_attrs == ref.BootStrapper._group_shared_attrs == ("_key",)


# ---------------------------------------------------------------------------
# the port's suppressions: the JAX package's 8 sites, and nowhere else
# ---------------------------------------------------------------------------

#: (file, rule) of every ``# metricslint: disable=`` comment the port carries:
#: the counterparts of the JAX package's sites (same files, same rules)
PORT_SUPPRESSIONS = Counter({
    ("parallel/sync.py", "data-dependent-collective"): 2,    # sync_in_jit, host_sync_state
    ("parallel/sync.py", "collective-in-handler"): 1,        # the quorum retry
    ("core/checkpoint.py", "guarded-telemetry-emit"): 4,     # snapshot, save, prune, load
    ("core/metric.py", "host-sync-in-update"): 1,            # merge_states' overflow flag
})


def _suppression_sites(pkg: Path) -> Counter:
    out: Counter = Counter()
    for path in sorted(pkg.rglob("*.py")):
        if "analysis" in path.relative_to(pkg).parts:
            continue
        for comment in _file_suppressions(path):
            rule = comment.split("disable=", 1)[1].split()[0]
            out[(str(path.relative_to(pkg)), rule)] += 1
    return out


def test_port_suppressions_are_the_reference_sites():
    assert _suppression_sites(ROOT / "metrics_tpu_torch") == PORT_SUPPRESSIONS
    assert _suppression_sites(ROOT / "metrics_tpu") == PORT_SUPPRESSIONS


def test_port_suppressions_are_real():
    """Stripping the comments resurfaces a finding at every site."""
    for rel in sorted({f for f, _ in PORT_SUPPRESSIONS}):
        path = ROOT / "metrics_tpu_torch" / rel
        src = path.read_text().replace("# metricslint: disable", "# stripped")
        resurfaced = analyze_source(src, str(path))
        expected = {r for f, r in PORT_SUPPRESSIONS if f == rel}
        if rel == "core/metric.py":
            continue  # a branch on a host bool: a runtime waiver (test_torch_analysis_runtime.py)
        assert expected <= rules_of(resurfaced), rel


# ---------------------------------------------------------------------------
# parity with the JAX package's linter
# ---------------------------------------------------------------------------

def _all_sources():
    out = []
    for base in ("metrics_tpu", "metrics_tpu_torch", "tests/analysis/fixtures", "tests/torch_analysis_fixtures"):
        out.extend(sorted((ROOT / base).rglob("*.py")))
    return out


def test_suppression_parsing_agrees_with_the_reference_on_every_file():
    """(a) For every source file of both packages and both fixture folders,
    the two ``parse_suppressions`` give equal maps, and the two
    ``filter_findings`` keep the same findings — probed at every suppressed
    line, the line after and every line of each covered span, for each rule
    of the catalog and one that is not in it."""
    rules = list(jax_report.RULES) + ["asymmetric-schedule-decision"]
    files = _all_sources()
    assert len(files) > 300
    for path in files:
        src = path.read_text()
        a, b = jax_report.parse_suppressions(src), port_report.parse_suppressions(src)
        assert a.by_line == b.by_line and a.spans == b.spans, path
        lines = set()
        for line in b.by_line:
            lines.update((line, line + 1, line + 2))
        for start, end, _ in b.spans:
            lines.update(range(start, end + 2))
        if not lines:
            continue
        probes = [(r, line) for r in rules for line in sorted(lines)]
        kept_a = jax_report.filter_findings([jax_report.Finding(r, str(path), n, 0, "m") for r, n in probes], src)
        kept_b = port_report.filter_findings([port_report.Finding(r, str(path), n, 0, "m") for r, n in probes], src)
        assert [(f.rule, f.line) for f in kept_a] == [(f.rule, f.line) for f in kept_b], path


@pytest.mark.parametrize("name", TWINS)
def test_fixture_twins_give_the_reference_findings(name):
    """(b) Line for line, the JAX linter on the JAX fixture and the port's
    linter on its twin give the same multiset of (rule, line, attr, owner)."""
    ref_findings, ref_errors = jax_analyze_paths([str(JAX_FIXTURES / name)])
    port_findings, port_errors = analyze_paths([fixture(name)])
    assert not ref_errors and not port_errors
    key = lambda fs: Counter((f.rule, f.line, f.attr, f.owner) for f in fs)  # noqa: E731
    assert key(port_findings) == key(ref_findings)


#: the JAX fixtures' stand-in collective is the port's seam in the twins
RENAMED = {"def _process_allgather": "def _gather"}


def test_twins_are_line_for_line():
    for name in TWINS:
        a = (JAX_FIXTURES / name).read_text().splitlines()
        b = (FIXTURES / name).read_text().splitlines()
        assert len(a) == len(b), name
        for la, lb in zip(a, b):
            for word in ("class ", "def "):
                if la.lstrip().startswith(word):
                    head = la.lstrip().split("(")[0].split(":")[0]
                    assert lb.lstrip().split("(")[0].split(":")[0] == RENAMED.get(head, head), (name, la)


def test_catalog_is_the_reference_catalog():
    assert port_report.RULES == jax_report.RULES
    # the gap kept for parity: the schedule pass emits a rule the catalog omits
    assert "asymmetric-schedule-decision" not in port_report.RULES
