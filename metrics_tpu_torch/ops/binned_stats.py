"""Binned PR-curve hot op: per-class, per-threshold TP/FP/FN counts.

Counterpart of ``metrics_tpu/ops/pallas_binned.py``. For ``[N, C]``
probabilities, ``[N, C]`` binary targets and ``[T]`` thresholds (in any
order) it returns three ``[C, T]`` float32 tensors, TP, FP and FN, where a
pred counts as positive at every threshold it is ``>=`` to (float32 compare;
a NaN pred is negative everywhere, a NaN threshold counts nothing).

Three implementations, equal bit for bit (ties and NaN included):

- :func:`_binned_stats_kernel` — the hand-written CUDA kernel
  (``csrc/binned_stats.cu``), which replaces the TPU kernel
  ``metrics_tpu/ops/pallas_binned.py::_kernel``. Every CUDA tensor goes here.
  It has two designs, picked by :func:`_plan` from the shapes alone: the
  shared-memory bucket histogram, and the compare kernel for thresholds too
  many for the histogram's tables. The launch is a registered op
  (``metrics_tpu_torch::binned_stats``) with a fake implementation, so that
  the compiled path's probe sees through it under ``FakeTensorMode`` and a
  CUDA graph capture records the kernel (and its scratch memset) on the
  capture stream. ``KERNEL_LAUNCHES`` counts a launch where the op body runs:
  once at a capture, which launches nothing; ``core/compiled.py`` takes the
  capture's count back and adds it again at every replay.
- :func:`_binned_stats_compare` — a broadcast ``[N, C, T]`` compare, the
  oracle the others are held against.
- :func:`_binned_stats_bucket` — the histogram kernel's algorithm in torch:
  each pred bucketed once against the sorted thresholds, a histogram, a
  suffix sum, a scatter back through the sort's permutation. The CPU path.
"""
import contextlib
import functools
from typing import Optional, Tuple

import torch

__all__ = ["binned_stat_scores", "KERNEL_LAUNCHES"]

#: Launches of the CUDA kernel in this process (one per call that launched).
KERNEL_LAUNCHES = 0

_TARGET_KINDS = {torch.float32: 0, torch.int32: 1, torch.int64: 2}
_DESIGNS = {"histogram": 0, "compare": 1}
_COMPARE_TILE = 32  # classes per block of the compare kernel (kCompareTile)
_THREADS = 256  # threads per block (kThreads)
# opt-in shared memory of a block on sm_90 (H100, H200), the one target the
# kernels are built for, and the bytes of it left for static shared variables
_SMEM_OPTIN = 232448
_SMEM_RESERVE = 1024

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _binned_stats_compare(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor) -> Stats:
    """Broadcast compare + reduce (port of ``_binned_stats_xla``)."""
    preds = preds.to(torch.float32)
    thresholds = thresholds.to(torch.float32)
    predictions = preds[:, :, None] >= thresholds[None, None, :]
    t = target[:, :, None].bool()
    tp = torch.sum(t & predictions, dim=0).to(torch.float32)
    fp = torch.sum(~t & predictions, dim=0).to(torch.float32)
    fn = torch.sum(t & ~predictions, dim=0).to(torch.float32)
    return tp, fp, fn


def _binned_stats_bucket(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor) -> Stats:
    """Bucket histogram, O(N*C*log T), for thresholds in any order.

    The thresholds are sorted (stable, NaN last) and ``bucket = #{sorted
    non-NaN thresholds <= pred}``; a NaN pred lands in bucket 0. Then the
    count at sorted threshold ``j`` is the sum of the histogram's bins above
    ``j``: a suffix sum of a ``[C, T+1, 2]`` int64 histogram that carries the
    target and the raw counts in one scatter. The sums go back to the
    thresholds' own order through the permutation and are cast to float32
    once, at the end.
    """
    preds = preds.to(torch.float32)
    thr = thresholds.to(torch.float32)
    n, c = preds.shape
    t = thr.shape[0]
    nan = torch.isnan(thr)
    order = torch.argsort(torch.where(nan, torch.full_like(thr, float("inf")), thr), stable=True)
    order = order[torch.argsort(nan[order].to(torch.uint8), stable=True)]
    sorted_thr = thr[order]
    valid = (~nan).sum()
    flat_p = preds.reshape(-1)
    # the NaN tail is +inf here and clamped away: +inf <= +inf would count it
    search = torch.where(torch.isnan(sorted_thr), torch.full_like(sorted_thr, float("inf")), sorted_thr)
    bucket = torch.minimum(torch.searchsorted(search, flat_p, right=True), valid)
    bucket = torch.where(torch.isnan(flat_p), torch.zeros_like(bucket), bucket)
    w = (target != 0).reshape(-1).to(torch.int64)
    cls = torch.arange(c, device=preds.device).repeat(n)
    vals = torch.stack([w, torch.ones_like(w)], dim=-1)
    hist = torch.zeros((c * (t + 1), 2), dtype=torch.int64, device=preds.device)
    hist.index_add_(0, cls * (t + 1) + bucket, vals)
    suffix = torch.flip(torch.cumsum(torch.flip(hist.reshape(c, t + 1, 2), [1]), dim=1), [1])
    tp = torch.empty((c, t), dtype=torch.int64, device=preds.device)
    cnt = torch.empty_like(tp)
    tp[:, order] = suffix[:, 1:, 0]
    cnt[:, order] = suffix[:, 1:, 1]
    pos = suffix[:, :1, 0]
    return tp.to(torch.float32), (cnt - tp).to(torch.float32), (pos - tp).to(torch.float32)


def _table_bytes(t: int) -> int:
    """The sort's permutation and the sorted thresholds, NaN-padded to T + P/2
    entries (P the power of two >= T) with one word of padding after every
    32: the part of a histogram block's shared memory outside its bins."""
    padded = t + (1 << max(0, (t - 1).bit_length())) // 2
    return 4 * t + 4 * (padded + padded // 32 + 1)


def _hist_smem_bytes(t: int, class_tile: int) -> int:
    """Shared memory of one histogram block (``hist_smem_bytes`` in the .cu):
    max(P, tile * (T+1)) 8-byte words (the sort keys, then the bins) and the
    tables."""
    return 8 * max(1 << max(0, (t - 1).bit_length()), class_tile * (t + 1)) + _table_bytes(t)


@functools.lru_cache(maxsize=4096)
def _plan(n: int, c: int, t: int, smem_limit: int, sm_count: int, design: Optional[str] = None) -> Tuple[str, int, int]:
    """``(design, class_tile, rows_per_block)`` for the kernel, from the shapes
    and the card alone (no device read).

    The histogram takes every shape whose tables fit a block's opt-in shared
    memory (``smem_limit``). Its grid is one wave, at most one block per SM,
    and no more blocks than give each thread about eight elements. Class
    tiles come first: a tile is a multiple of eight classes where ``C`` is
    (whole 32-byte sectors of a row, 16-byte loads), else of four where ``C``
    is, and row blocks split the rows only when the class tiles do not fill
    the wave, with at least about four rows per bin in a row block, so that
    a block's flush stays small against its work. One row block needs no
    scratch and no merge. The compare kernel takes the rest (more than about
    8192 thresholds), with row chunks of 32 to 256 rows and about four blocks
    per SM. ``design`` forces one of the two; forcing the histogram where it
    does not fit raises.
    """
    if design not in (None, "histogram", "compare"):
        raise ValueError(f"binned_stats kernel: unknown design {design!r}")
    budget = smem_limit - _SMEM_RESERVE
    if design != "compare" and _hist_smem_bytes(t, 1) <= budget:
        blocks = max(1, min(sm_count, -(-n * c // (8 * _THREADS))))
        tile = -(-c // blocks)
        max_tile = (budget - _table_bytes(t)) // (8 * (t + 1))
        for width in (8, 4):
            if c % width == 0 and max_tile >= width:
                tile = -(-tile // width) * width
                max_tile -= max_tile % width
                break
        tile = max(1, min(tile, max_tile, c))
        row_blocks = max(1, min(blocks // -(-c // tile), n // (4 * (t + 1))))
        return "histogram", tile, -(-n // row_blocks)
    if design == "histogram":
        raise ValueError(f"binned_stats kernel: T={t} thresholds do not fit the histogram's shared memory")
    want_x = max(1, (4 * sm_count) // -(-c // _COMPARE_TILE))
    return "compare", _COMPARE_TILE, min(256, max(32, -(-n // want_x)))


def _scratch_bytes(design: str, n: int, c: int, t: int, class_tile: int, rows_per_block: int) -> int:
    """Device scratch of one launch (``scratch_bytes_needed`` in the .cu)."""
    if design == "compare":
        return 4 * (2 * c * t + c + -(-c // _COMPARE_TILE))
    if -(-n // rows_per_block) <= 1:
        return 0
    return 8 * c * (t + 1) + 4 * -(-c // class_tile)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@torch.library.custom_op("metrics_tpu_torch::binned_stats", mutates_args=(), device_types="cuda")
def _binned_stats_op(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor, design: str) -> torch.Tensor:
    """One launch of the CUDA kernel on validated inputs: the float32
    ``[3, C, T]`` counts. ``design`` is ``"histogram"``, ``"compare"`` or
    ``""`` (let :func:`_plan` pick)."""
    global KERNEL_LAUNCHES
    from metrics_tpu_torch.ops._build import load_library

    n, c = preds.shape
    t = thresholds.shape[0]
    device = preds.device
    lib = load_library()
    chosen, tile, rows = _plan(n, c, t, _SMEM_OPTIN, _sm_count(device.index), design=design or None)
    nbytes = _scratch_bytes(chosen, n, c, t, tile, rows)
    out = torch.empty((3, c, t), dtype=torch.float32, device=device)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None
    # the C entry launches on the current device's context: switch only when
    # the tensors live on another card
    switch = device.index != torch.cuda.current_device()
    with torch.cuda.device(device) if switch else contextlib.nullcontext():
        err = lib.binned_stats_launch(
            preds.data_ptr(), target.data_ptr(), _TARGET_KINDS[target.dtype], thresholds.data_ptr(),
            n, c, t, _DESIGNS[chosen], tile, rows,
            scratch.data_ptr() if nbytes else None, nbytes, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"binned_stats kernel ({chosen}) launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


@_binned_stats_op.register_fake
def _binned_stats_fake(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor, design: str) -> torch.Tensor:
    return preds.new_empty((3, preds.shape[1], thresholds.shape[0]), dtype=torch.float32)


def _binned_stats_kernel(
    preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor, design: Optional[str] = None
) -> Stats:
    """The CUDA kernel: one float32 ``[3, C, T]`` result, returned as three
    views. ``design`` forces the histogram or the compare kernel (for
    comparing the two); ``None`` lets :func:`_plan` pick."""
    for name, x in (("preds", preds), ("target", target), ("thresholds", thresholds)):
        if not x.is_cuda:
            raise ValueError(f"binned_stats kernel: `{name}` must be a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"binned_stats kernel: `{name}` must be contiguous")
    if preds.device != target.device or preds.device != thresholds.device:
        raise ValueError(
            f"binned_stats kernel: tensors on different devices ({preds.device}, {target.device}, {thresholds.device})"
        )
    if preds.dtype != torch.float32 or thresholds.dtype != torch.float32:
        raise ValueError(
            f"binned_stats kernel: `preds` and `thresholds` must be float32, got {preds.dtype} and {thresholds.dtype}"
        )
    if target.dtype not in _TARGET_KINDS:
        raise ValueError(f"binned_stats kernel: unsupported target dtype {target.dtype}")
    if preds.ndim != 2 or target.shape != preds.shape or thresholds.ndim != 1:
        raise ValueError(
            "binned_stats kernel: expected preds [N, C], target [N, C] and thresholds [T], got "
            f"{tuple(preds.shape)}, {tuple(target.shape)} and {tuple(thresholds.shape)}"
        )
    n, c = preds.shape
    t = thresholds.shape[0]
    if c * t >= 2**31 or n >= 2**31:
        raise ValueError(f"binned_stats kernel: shape (N={n}, C={c}, T={t}) exceeds int32 counts")
    if not (n and c and t):
        return torch.zeros((3, c, t), dtype=torch.float32, device=preds.device).unbind(0)
    return torch.ops.metrics_tpu_torch.binned_stats(preds, target, thresholds, design or "").unbind(0)


def binned_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: torch.Tensor,
    use_kernel: Optional[bool] = None,
) -> Stats:
    """Per-class, per-threshold (TP, FP, FN) counts for binned PR metrics.

    Args:
        preds: ``[N, C]`` probabilities (float32 and contiguous on CUDA).
        target: ``[N, C]`` binary labels (float32, int32 or int64 on CUDA).
        thresholds: ``[T]`` decision thresholds, in any order.
        use_kernel: ``None`` picks by device: a CUDA tensor launches the CUDA
            kernel (no fallback), a CPU tensor takes the bucket form.
            ``True`` demands the kernel and raises on a CPU tensor. ``False``
            forces the compare form, on either device — the oracle the kernel
            is held against.

    Returns:
        Three ``[C, T]`` float32 tensors: true positives, false positives and
        false negatives at each (class, threshold).
    """
    if use_kernel is False:
        return _binned_stats_compare(preds, target, thresholds)
    if preds.is_cuda:
        return _binned_stats_kernel(preds, target, thresholds)
    if use_kernel:
        raise ValueError(
            "binned_stat_scores(use_kernel=True) needs CUDA tensors; the kernel does not run on the CPU"
        )
    return _binned_stats_bucket(preds, target, thresholds)
