"""metricslint for the port, the CLI: the JAX suite (``tests/analysis/test_cli.py``)
case for case — exit codes, output format, ``--list-rules`` (the JAX
package's catalog), error handling — plus the gate: ``python -m
metrics_tpu_torch.analysis`` exits 0 over the port and 1 on every violating
torch fixture, each with exactly the rules of its JAX twin plus its
torch-only rules.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from metrics_tpu.analysis import analyze_paths as jax_analyze_paths
from metrics_tpu.analysis.__main__ import main as jax_main
from metrics_tpu_torch.analysis import analyze_paths
from metrics_tpu_torch.analysis.__main__ import main
from metrics_tpu_torch.analysis.report import RULES

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_analysis_fixtures"
JAX_FIXTURES = ROOT / "tests" / "analysis" / "fixtures"
VIOLATING = sorted(str(p) for p in FIXTURES.glob("violating_*.py"))

#: the rules each torch-only fixture adds (the twins add none)
TORCH_ONLY_RULES = {
    "violating_inplace_state.py": {"undeclared-state"},
    "violating_torch_host_sync.py": {"host-sync-in-update"},
    "violating_rank_taint.py": {"rank-dependent-collective", "data-dependent-collective",
                                "nondeterministic-collective-order"},
}


def test_violating_fixtures_exit_nonzero(capsys):
    assert len(VIOLATING) == 11, "violation fixtures missing"
    for path in VIOLATING:
        assert main([path]) == 1, f"{path} must fail the lint"
        assert os.path.basename(path) in capsys.readouterr().out


@pytest.mark.parametrize("path", VIOLATING, ids=os.path.basename)
def test_violating_fixture_rules_are_the_twins(path):
    name = os.path.basename(path)
    rules = {f.rule for f in analyze_paths([path])[0]}
    twin = JAX_FIXTURES / name
    expected = {f.rule for f in jax_analyze_paths([str(twin)])[0]} if twin.exists() else set()
    assert rules == expected | TORCH_ONLY_RULES.get(name, set())


def test_clean_and_suppressed_fixtures_exit_zero(capsys):
    assert main([str(FIXTURES / "clean_metric.py")]) == 0
    assert main([str(FIXTURES / "suppressed_metric.py")]) == 0


def test_finding_format_is_path_line_col_rule(capsys):
    main([str(FIXTURES / "violating_undeclared_state.py")])
    first = capsys.readouterr().out.splitlines()[0]
    path, line, col, rule = first.split(":", 3)
    assert path.endswith("violating_undeclared_state.py")
    assert int(line) > 0 and int(col) >= 0
    assert rule.strip().startswith("undeclared-state")


def test_list_rules_prints_the_reference_catalog(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out
    assert jax_main(["--list-rules"]) == 0
    assert capsys.readouterr().out == out


def test_missing_path_is_usage_error(capsys):
    assert main([str(FIXTURES / "no_such_file.py")]) == 2


def test_unparsable_file_exits_nonzero(tmp_path, capsys):
    bad = tmp_path / "broken.py"
    bad.write_text("def update(:\n")
    assert main([str(bad)]) == 1
    assert "SyntaxError" in capsys.readouterr().err


def test_no_schedule_flag_skips_schedule_rules(capsys):
    path = str(FIXTURES / "violating_schedule.py")
    assert main([path]) == 1
    capsys.readouterr()
    assert main([path, "--no-schedule"]) == 0


def test_quiet_flag_drops_the_summary(capsys):
    main([str(FIXTURES / "clean_metric.py"), "-q"])
    assert capsys.readouterr().err == ""
    main([str(FIXTURES / "clean_metric.py")])
    assert "metricslint: 0 finding(s)" in capsys.readouterr().err


def test_analysis_modules_import_neither_torch_nor_jax():
    """The AST passes and the bridge import nothing of torch, jax or the JAX
    package (the runtime bridge reads live classes, never imports them)."""
    import ast

    for path in sorted((ROOT / "metrics_tpu_torch" / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("torch", "jax", "jaxlib", "metrics_tpu"), (path.name, n)


def test_gate_via_module_subprocess():
    """The gate, as one subprocess for each command: with no paths the CLI
    lints the port (exit 0), every violating torch fixture exits 1 and
    ``--list-rules`` prints the JAX package's catalog."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "metrics_tpu_torch.analysis"]
    runs = {
        "package": subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "fixtures": subprocess.Popen(
            [sys.executable, "-c", (
                "import sys; from metrics_tpu_torch.analysis.__main__ import main; "
                "sys.exit(max(abs(main([p, '-q']) - 1) for p in sys.argv[1:]))")] + VIOLATING,
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "rules": subprocess.Popen(cmd + ["--list-rules"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True),
    }
    out = {k: p.communicate(timeout=120) + (p.returncode,) for k, p in runs.items()}
    assert out["package"][2] == 0, out["package"][0] + out["package"][1]
    assert "0 finding(s)" in out["package"][1]
    assert out["fixtures"][2] == 0, out["fixtures"][0] + out["fixtures"][1]
    assert out["rules"][2] == 0
    assert [line.split()[0] for line in out["rules"][0].splitlines()] == list(RULES)
