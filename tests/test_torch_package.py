"""Package rules of the PyTorch port.

- No module of ``metrics_tpu_torch`` and not ``chip_smoke.py`` imports JAX or
  anything of the JAX package ``metrics_tpu``: the port keeps its own copies.
- Metrics run on the card by default: without CUDA, a metric constructed
  without ``device="cpu"`` raises instead of quietly running on the host.
"""
import ast
from pathlib import Path

import pytest
import torch

import metrics_tpu_torch as port

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "metrics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "metrics_tpu")


def test_port_files_are_found():
    names = {p.name for p in PORT_FILES}
    assert {"metric.py", "binned_stats.py", "chip_smoke.py", "_build.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matches_the_reference_but_not_the_port():
    assert _forbidden("metrics_tpu.utils.enums")
    assert _forbidden("jax.numpy")
    assert not _forbidden("metrics_tpu_torch.utils.enums")


def test_kernel_sources_ship_with_the_package():
    assert (ROOT / "metrics_tpu_torch" / "csrc" / "binned_stats.cu").exists()
    assert '"metrics_tpu_torch" = ["csrc/*.cu"]' in (ROOT / "pyproject.toml").read_text()


DOCTEST_MODULES = [
    "metrics_tpu_torch.core.collections",
    "metrics_tpu_torch.classification.accuracy",
    "metrics_tpu_torch.classification.stat_scores",
    "metrics_tpu_torch.classification.binned_precision_recall",
    "metrics_tpu_torch.functional.classification.accuracy",
    "metrics_tpu_torch.functional.classification.stat_scores",
]


@pytest.mark.parametrize("module", DOCTEST_MODULES)
def test_docstring_examples_run(module):
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(module))
    assert result.attempted > 0 and result.failed == 0, result


@pytest.mark.parametrize("make", [
    lambda **kw: port.Accuracy(num_classes=10, **kw),
    lambda **kw: port.StatScores(reduce="macro", num_classes=10, **kw),
    lambda **kw: port.BinnedAveragePrecision(num_classes=10, **kw),
], ids=["Accuracy", "StatScores", "BinnedAveragePrecision"])
def test_default_device_is_cuda(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert make(device="cpu").device == torch.device("cpu")
