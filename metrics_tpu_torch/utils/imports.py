"""Optional-dependency detection.

Counterpart of ``metrics_tpu/utils/imports.py``: the packages this port
consults only when present (nltk for ROUGE stemming and sentence splitting,
transformers for named BERTScore models, scipy for PIT's Hungarian solve)
are probed here once, at import, without importing them.
"""
import importlib
import importlib.util
from typing import Callable


def _module_available(module_path: str) -> bool:
    """True if ``module_path`` is importable, without importing it."""
    try:
        return importlib.util.find_spec(module_path) is not None
    except (ModuleNotFoundError, AttributeError, ValueError):
        return False


def _compare_version(package: str, op: Callable, version: str) -> bool:
    """``op(installed version of package, version)``; False when the package
    or its version cannot be read."""
    from packaging.version import Version

    try:
        pkg = importlib.import_module(package)
        pkg_version = Version(getattr(pkg, "__version__", "0"))
    except (ImportError, TypeError):
        return False
    return op(pkg_version, Version(version))


_TORCH_AVAILABLE = True  # this package imports torch
_TRANSFORMERS_AVAILABLE = _module_available("transformers")
_NLTK_AVAILABLE = _module_available("nltk")
_ROUGE_SCORE_AVAILABLE = _module_available("rouge_score")
_SCIPY_AVAILABLE = _module_available("scipy")
