"""Case-insensitive string enums used across the metric surface.

Counterpart of ``metrics_tpu/utils/enums.py``; the port keeps its own copy so
that it never imports the JAX package.
"""
from enum import Enum
from typing import Optional, Union


class EnumStr(str, Enum):
    """String-valued enum with case-insensitive ``from_str`` lookup."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError:
            return None

    def __eq__(self, other: Union[str, Enum, None]) -> bool:  # type: ignore[override]
        other = other.value if isinstance(other, Enum) else str(other)
        return self.value.lower() == other.lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())


class DataType(EnumStr):
    """The kind of classification input detected by input formatting."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """How per-class statistics are averaged into a final score."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """How the extra sample dimension of multi-dim multi-class inputs is handled."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"
