"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``metrics_tpu``, compared by whole top-level names (the port's name,
``metrics_tpu_torch``, begins with the JAX package's)."""
import ast
import os
import subprocess
import sys
import textwrap
import types

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "metrics_tpu"}


def test_whole_names_are_compared(monkeypatch):
    import metrics_tpu_torch  # noqa: F401
    import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "metrics_tpu.core", types.ModuleType("metrics_tpu.core"))
    assert run.forbidden_modules() == ["metrics_tpu"]


def test_no_source_under_the_benchmark_imports_them():
    for base, _, files in os.walk(tiny.BENCH):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(base, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    tops = {node.module.split(".")[0]}
                else:
                    continue
                assert not tops & FORBIDDEN, (name, tops)


def test_a_whole_run_loads_none_of_them(tmp_path):
    """Every harness module, the reference and every reader, then one run of
    each kind, in a fresh interpreter."""
    root = tiny.checkout(str(tmp_path))
    code = textwrap.dedent(f"""
        import glob, json, os, sys
        sys.path[:0] = [{tiny.BENCH!r}, {tiny.ROOT!r}]
        import run, calibrate
        from harness import cell, gate, result, roofline, spec, traffic, tracing
        for kind in ("layer_metrics", "reference"):
            for p in glob.glob(os.path.join({tiny.BENCH!r}, kind, "*.py")):
                spec.load_module(kind, os.path.basename(p)[:-3])
        for c in ("imagenet1k-report.eval", "cityscapes-seg.labels"):
            assert run.main(["--workload", c, "--seed", "5", "--seconds", "0.2", "--trace", "1"],
                            device_kind="cpu", root={root!r}) == 0
        print("FORBIDDEN", json.dumps(run.forbidden_modules()))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'FORBIDDEN []' in out.stdout
