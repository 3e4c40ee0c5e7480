"""The benchmark runs the port alone: no ``jax``, ``jaxlib``, ``flax`` or JAX
package ``metrics_tpu`` in the process, compared by whole top-level names
(the port's name, ``metrics_tpu_torch``, begins with the JAX package's)."""
import sys

FORBIDDEN = {"jax", "jaxlib", "flax", "metrics_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
