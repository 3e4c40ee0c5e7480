"""Fixed-capacity "cat" states: a preallocated buffer and a fill count.

Counterpart of ``metrics_tpu/core/cat_buffer.py``. A list state
(``add_state(default=[], dist_reduce_fx="cat")``) grows by one tensor per
batch and is concatenated at ``compute()``; ``metric.with_capacity(n)``
replaces every such state of a metric by a :class:`CatBuffer`: a
``[capacity, ...]`` tensor allocated at the first ``append`` and filled from
the front. ``compute()`` then either reads the valid rows (``values()``) or
runs a padding-aware computation over the whole buffer with ``mask()``
(``ops/ranking.py``).

What differs from the JAX package, and why:

- **The fill count is a Python int.** The JAX package keeps it on the device
  so that ``append`` can run inside ``jit``, and reads it back for its
  overflow check. The port never traces, and ``append`` knows each batch's
  row count on the host, so the count stays there: ``append`` costs no host
  read, and an append past capacity always raises before it writes. A tensor
  is made from the count only where a collective or ``mask()`` needs one.
- **``overflowed`` stays, as a bool.** No append of the port sets it, but a
  JAX snapshot (``utils/convert.py``) whose rows were clamped inside ``jit``
  carries it set: ``values()`` raises on it, ``poison`` turns a value into
  NaN, and ``merge`` and sync keep it, as in the JAX package.
- **Appends write in place** (``buffer[count:count + n].copy_(batch)``), where
  the JAX package builds a new array each time. So storage is never shared
  between two live buffers: :meth:`copy` is copy-on-write (the first append
  to either side clones the tensor), ``merge`` returns fresh storage, and a
  metric's defaults, ``clone()``, pickles, ``state_dict()`` and the batch
  state of ``forward`` hold tensors of their own.
- The defaults do not materialize after the first update (the JAX package
  does so to keep ``lax.scan`` carries stable), so after ``reset()`` the next
  append may fix another item shape.
- **Inside a compiled program** (``core/compiled.py``) the fill offset is
  also kept on the device (``_offset``, an int64 scalar), and ``append``
  writes at it and advances it: a replayed CUDA graph writes the next rows
  each step, where a host offset baked into the capture would write the same
  rows again. The host count still moves, by the batch's static row count
  after each replay, so an append past capacity raises before the replay
  writes. Whatever sets the count outside a program (``reset``, ``merge``,
  a load, a sync) makes a new buffer or goes through the metric's state
  restore, and the next dispatch seeds the device offset from the host count.
- ``fresh_copy`` (JAX buffer donation) has no counterpart. The host sync of
  a CatBuffer state is in ``parallel/sync.py``; :func:`sync_cat_buffer_in_jit`
  is the in-program one, which reads the gathered fill counts on the host,
  so it runs eagerly and raises inside a captured program.

Padding rows stay zero: the buffer is born zeroed, an append writes only its
own rows, and ``merge`` copies into a zeroed tail, so :meth:`has_nonfinite`
may scan the whole buffer.
"""
from typing import Optional, Union

import torch

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["CatBuffer", "sync_cat_buffer_in_jit"]


def _in_program() -> bool:
    from metrics_tpu_torch.core.compiled import in_program

    return in_program()


class CatBuffer:
    """A bounded accumulation buffer for a "cat" metric state.

    Attributes:
        capacity: the most rows it holds.
        buffer: ``[capacity, *item_shape]`` tensor, or ``None`` until the
            first ``append`` fixes the item shape, dtype and device.
        count: the number of valid rows, a Python int.
        overflowed: set when a JAX snapshot that overflowed inside ``jit``
            was loaded into this buffer; sticky through copy, merge and sync.

    Example:
        >>> import torch
        >>> cb = CatBuffer(4)
        >>> _ = cb.append(torch.tensor([1.0, 2.0])).append(torch.tensor(3.0))
        >>> cb.values().tolist(), cb.mask().tolist()
        ([1.0, 2.0, 3.0], [True, True, True, False])
    """

    __slots__ = ("capacity", "buffer", "count", "overflowed", "_shared", "_offset")

    def __init__(
        self,
        capacity: int,
        buffer: Optional[torch.Tensor] = None,
        count: int = 0,
        overflowed: bool = False,
    ) -> None:
        if capacity <= 0:
            raise ValueError(f"CatBuffer capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.buffer = buffer
        self.count = int(count)
        self.overflowed = bool(overflowed)
        # True while ``buffer`` may be shared with a copy: the next append
        # clones it first
        self._shared = False
        # the device-side fill offset of a compiled program's state slot
        self._offset: Optional[torch.Tensor] = None

    # -- accumulation ---------------------------------------------------
    def append(self, batch: Union[torch.Tensor, float, int]) -> "CatBuffer":
        """Write a batch of rows at the fill offset, in place; returns self."""
        batch = torch.as_tensor(batch)
        if batch.ndim == 0:
            batch = batch.reshape(1)
        n = batch.shape[0]
        if self.buffer is None:
            self.buffer = torch.zeros((self.capacity,) + tuple(batch.shape[1:]), dtype=batch.dtype, device=batch.device)
            self._shared = False
        if n > self.capacity:
            raise MetricsTPUUserError(f"Batch of {n} rows exceeds CatBuffer capacity {self.capacity}.")
        if tuple(batch.shape[1:]) != tuple(self.buffer.shape[1:]):
            raise MetricsTPUUserError(
                f"CatBuffer item shape mismatch: buffer holds {tuple(self.buffer.shape[1:])} "
                f"rows but got {tuple(batch.shape[1:])}. One metric instance cannot mix "
                "item shapes; create a fresh metric for differently-shaped inputs."
            )
        if self.count + n > self.capacity:
            raise MetricsTPUUserError(
                f"CatBuffer overflow: {self.count} + {n} > capacity {self.capacity}. "
                "Construct the metric with a larger `with_capacity(...)`."
            )
        if self._offset is not None and _in_program():
            rows = self._offset + torch.arange(n, device=self.buffer.device)
            self.buffer.index_copy_(0, rows, batch.to(device=self.buffer.device, dtype=self.buffer.dtype))
            self._offset.add_(n)
            self.count += n
            return self
        if self._shared:
            self.buffer = self.buffer.clone()
            self._shared = False
        self.buffer[self.count:self.count + n].copy_(batch)
        self.count += n
        return self

    def device_offset(self) -> torch.Tensor:
        """The fill offset as an int64 scalar on the buffer's device: the
        program slot's own, or one made from the host count."""
        if self._offset is not None:
            return self._offset
        return torch.full((), self.count, dtype=torch.int64, device=self.buffer.device)

    # -- reads ----------------------------------------------------------
    def values(self) -> torch.Tensor:
        """The valid rows ``buffer[:count]`` (a view, not a copy)."""
        if self.buffer is None:
            return torch.zeros((0,))
        if self.overflowed:
            raise MetricsTPUUserError(
                f"CatBuffer overflowed inside jit: more than capacity={self.capacity} "
                "rows were appended, and late rows overwrote earlier ones. The data "
                "is corrupt — construct the metric with a larger `with_capacity(...)` "
                "and re-run."
            )
        return self.buffer[: self.count]

    def mask(self) -> torch.Tensor:
        """``[capacity]`` bool validity mask, on the buffer's device."""
        device = None if self.buffer is None else self.buffer.device
        return torch.arange(self.capacity, device=device) < self.count

    def poison(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` unchanged, or NaN (with a warning) if this buffer has
        overflowed. An integer ``value`` becomes float32 only then, since NaN
        needs a float carrier."""
        value = torch.as_tensor(value)
        if not self.overflowed:
            return value
        rank_zero_warn(
            f"CatBuffer overflowed (capacity {self.capacity}): compute returns "
            "NaN. Construct the metric with a larger `with_capacity(...)`."
        )
        out_dtype = value.dtype if value.is_floating_point() else torch.float32
        return torch.full_like(value, float("nan"), dtype=out_dtype)

    def has_nonfinite(self) -> torch.Tensor:
        """Scalar bool tensor: any NaN/Inf among the rows. Padding rows are
        zero, so the whole buffer is scanned without a mask; integer and bool
        buffers are always finite."""
        if self.buffer is None or not (self.buffer.is_floating_point() or self.buffer.is_complex()):
            return torch.zeros((), dtype=torch.bool)
        return torch.logical_not(torch.all(torch.isfinite(self.buffer)))

    def __len__(self) -> int:
        return self.count

    # -- structure -------------------------------------------------------
    def copy(self) -> "CatBuffer":
        """A copy that shares the tensor until either side appends (O(1))."""
        out = CatBuffer(self.capacity, self.buffer, self.count, self.overflowed)
        if self.buffer is not None:
            self._shared = out._shared = True
        return out

    def reset(self) -> "CatBuffer":
        """An empty buffer of the same capacity."""
        return CatBuffer(self.capacity)

    def merge(self, other: "CatBuffer") -> "CatBuffer":
        """A new CatBuffer holding self's rows, then other's (capacity =
        self's), on storage of its own. Raises when they do not fit."""
        if other.buffer is None:
            out = self.copy()
            out.overflowed = self.overflowed or other.overflowed
            return out
        if self.buffer is None:
            base = CatBuffer(self.capacity, overflowed=self.overflowed)
            base.buffer = torch.zeros(
                (self.capacity,) + tuple(other.buffer.shape[1:]), dtype=other.buffer.dtype, device=other.buffer.device)
            return base.merge(other)
        if self.count + other.count > self.capacity:
            raise MetricsTPUUserError(
                f"CatBuffer overflow on merge: {self.count} + {other.count} > capacity {self.capacity}."
            )
        buffer = self.buffer.clone()
        buffer[self.count:self.count + other.count].copy_(other.buffer[: other.count])
        return CatBuffer(self.capacity, buffer, self.count + other.count, self.overflowed or other.overflowed)

    def _apply(self, fn) -> "CatBuffer":
        """Apply a tensor function (``.to()``, a dtype cast) to the buffer in
        place; the count and the flag are host values and stay."""
        if self.buffer is not None:
            moved = fn(self.buffer)
            if moved is not self.buffer:
                self.buffer, self._shared = moved, False
        return self

    def __repr__(self) -> str:
        item = None if self.buffer is None else tuple(self.buffer.shape[1:])
        return f"CatBuffer(capacity={self.capacity}, count={self.count}, item_shape={item})"


def sync_cat_buffer_in_jit(cb: CatBuffer, axis_name) -> CatBuffer:
    """All-gather a CatBuffer over ``axis_name`` into one compacted buffer of
    ``world * capacity`` rows, every rank's valid rows in rank order, the
    tail zero; ``overflowed`` if any rank's was. Two collectives through the
    in-program seam (``parallel/sync.py::_program_collective``): the
    ``[capacity, ...]`` buffers and one ``[count, overflow]`` pair per rank.
    The merged count is a host int, so the counts are read on the host: a
    captured program cannot hold that read, and this raises inside one."""
    from metrics_tpu_torch.core.compiled import program_context
    from metrics_tpu_torch.parallel import sync as sync_mod

    if cb.buffer is None:
        raise MetricsTPUUserError("Cannot sync an empty CatBuffer (no item shape yet).")
    if program_context():
        raise MetricsTPUUserError(
            "sync_cat_buffer_in_jit reads the gathered row counts on the host, which a captured "
            "program cannot hold: sync a CatBuffer state outside the program (sync()/pure_sync)."
        )
    device = cb.buffer.device
    bufs = sync_mod._program_collective(cb.buffer, "cat", axis_name)  # [W * capacity, ...]
    meta = torch.tensor([[cb.count, int(cb.overflowed)]], dtype=torch.int64, device=device)
    meta = sync_mod._program_collective(meta, "cat", axis_name).cpu()  # [W, 2]
    world = meta.shape[0]
    item = tuple(cb.buffer.shape[1:])
    out = torch.zeros((world * cb.capacity,) + item, dtype=cb.buffer.dtype, device=device)
    rows = bufs.reshape((world, cb.capacity) + item)
    count = 0
    for r, n in enumerate(meta[:, 0].tolist()):
        out[count:count + n].copy_(rows[r, :n])
        count += n
    return CatBuffer(world * cb.capacity, out, count, bool((meta[:, 1] > 0).any()))
