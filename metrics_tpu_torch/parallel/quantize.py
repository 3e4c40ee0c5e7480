"""Slow-hop payload codecs of the tiered sync schedule.

Counterpart of ``metrics_tpu/parallel/quantize.py``. The tiered bucketed
sync (``parallel/bucketing.py``) applies one of two opt-in encodings to the
ONE inter-tier exchange of a bucket, never to the intra-tier hops, and only
when the metric or collection was built with ``sync_precision=``:

- ``"bf16"``: float payloads cast to ``bfloat16`` (round to nearest even);
- ``"int8"``: block-scaled int8, :data:`BLOCK` elements a block with one
  float32 scale (``maxabs / 127``), the scales' bytes appended to the same
  int8 wire, so the exchange stays one collective a bucket.

The wire is the JAX package's, byte for byte:

- **Rounding** is half to even (``torch.round``, as ``jnp.round``; the JAX
  docstring's "half away from zero" is not what its code does):
  ``[0.5, 1.5, -0.5, 2.5]`` at scale 1.0 encode to ``[0, 2, 0, 2]``.
- **A NaN** makes its block's ``maxabs`` NaN, so the block's scale is 1.0;
  the NaN element encodes as 0 (XLA's float-to-int8 conversion of NaN). A
  cast of NaN to int8 is undefined on the card, so the 0 is explicit here.
- **An Inf** makes the scale ``inf``: every element of the block encodes as
  0 (``inf / inf`` is NaN) and decodes as NaN (``0 * inf``).
- **The scales' bytes** are each float32's little-endian bytes
  (``scale.view(torch.int8)``, as ``lax.bitcast_convert_type``); every
  division is by a tensor, so the card rounds each quotient as the CPU does.

Integer and bool payloads pass through unencoded; a bucket's dtype is fixed
by the schema, so the choice is the same on every rank. The cross-tier
combine of reduce partials is :func:`kahan_sum`, a loop of four eager ops a
tier in tier order (never ``torch.sum``, and nothing that could fuse the
four: a fused multiply-add would undo the compensation).

The precision rides the health word's precision column (protocol v5,
``parallel/health.py``), so ranks that mix precisions raise
``StateDivergenceError`` together before any payload moves.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = [
    "BLOCK",
    "PRECISION_CODES",
    "SYNC_PRECISIONS",
    "decode",
    "encode",
    "encoded_size",
    "kahan_sum",
    "precision_code",
    "validate_sync_precision",
]

#: Accepted ``sync_precision=`` values (``None``/"full": no quantization).
SYNC_PRECISIONS = (None, "full", "bf16", "int8")

#: The health word's precision-column codes (0 is full precision).
PRECISION_CODES = {None: 0, "full": 0, "bf16": 1, "int8": 2}

#: int8 block size: one float32 scale a block of BLOCK elements.
BLOCK = 256


def validate_sync_precision(precision: Any) -> Optional[str]:
    """Normalize the knob: ``None`` (full precision), ``"bf16"`` or ``"int8"``."""
    if precision in (None, "full"):
        return None
    if precision in ("bf16", "int8"):
        return precision
    raise MetricsTPUUserError(f"`sync_precision` must be one of {SYNC_PRECISIONS}, got {precision!r}")


def precision_code(precision: Optional[str]) -> int:
    """The health-word column of a (normalized) precision."""
    return PRECISION_CODES[precision]


def _quantizable(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point


def encoded_size(n: int, dtype: torch.dtype, precision: Optional[str]) -> int:
    """Elements on the wire for an ``n``-element payload: the same on every
    rank for the same ``n``."""
    if precision is None or not _quantizable(dtype) or precision == "bf16":
        return int(n)
    nb = -(-int(n) // BLOCK)
    return nb * BLOCK + nb * 4  # int8 payload + the float32 scales' bytes


def encode(flat: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """The 1-D wire of a flat payload, on its device. Full precision and
    non-float payloads pass through."""
    if precision is None or not _quantizable(flat.dtype):
        return flat
    if precision == "bf16":
        return flat.to(torch.bfloat16)
    n = flat.numel()
    nb = -(-n // BLOCK)
    padded = torch.nn.functional.pad(flat.to(torch.float32), (0, nb * BLOCK - n)).reshape(nb, BLOCK)
    maxabs = torch.amax(torch.abs(padded), dim=1)
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which can round an ulp away from XLA's (and the CPU's) quotient
    scale = torch.where(maxabs > 0, maxabs / torch.full_like(maxabs, 127.0), torch.ones_like(maxabs))
    q = torch.clamp(torch.round(padded / scale[:, None]), -127, 127)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q).to(torch.int8)
    return torch.cat([q.reshape(-1), scale.contiguous().view(torch.int8)])


def decode(wire: torch.Tensor, n: int, dtype: torch.dtype, precision: Optional[str]) -> torch.Tensor:
    """Invert :func:`encode` to ``n`` elements of ``dtype``. A 2-D ``wire``
    (the gathered ``[participants, encoded]`` rows) decodes row by row."""
    if precision is None or not _quantizable(dtype):
        return wire
    if wire.ndim == 2:
        return torch.stack([decode(row, n, dtype, precision) for row in wire])
    if precision == "bf16":
        return wire[:n].to(dtype)
    nb = -(-int(n) // BLOCK)
    q = wire[: nb * BLOCK].to(torch.float32).reshape(nb, BLOCK)
    scale = wire[nb * BLOCK: nb * BLOCK + nb * 4].contiguous().view(torch.float32)
    return (q * scale[:, None]).reshape(-1)[:n].to(dtype)


def kahan_sum(rows: torch.Tensor) -> torch.Tensor:
    """Compensated (Kahan) sum over dim 0 of ``[k, n]`` in float32, in row
    (tier) order: the cross-tier combine of quantized reduce partials."""
    rows = rows.to(torch.float32)
    total = torch.zeros(rows.shape[1:], dtype=torch.float32, device=rows.device)
    comp = torch.zeros_like(total)
    for i in range(rows.shape[0]):
        y = rows[i] - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total
