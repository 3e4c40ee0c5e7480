"""Binned PR-curve hot op: per-class, per-threshold TP/FP/FN counts.

Counterpart of ``metrics_tpu/ops/pallas_binned.py``. For ``[N, C]``
probabilities, ``[N, C]`` binary targets and ``[T]`` thresholds it returns
three ``[C, T]`` float32 tensors, TP, FP and FN, where a pred counts as
positive at every threshold it is ``>=`` to (float32 compare; a NaN pred is
negative everywhere).

Three implementations, equal bit for bit (ties and NaN included):

- :func:`_binned_stats_kernel` — the hand-written CUDA kernel
  (``csrc/binned_stats.cu``), which replaces the TPU kernel
  ``metrics_tpu/ops/pallas_binned.py::_kernel``. Every CUDA tensor goes here.
- :func:`_binned_stats_compare` — a broadcast ``[N, C, T]`` compare, the
  oracle the others are held against.
- :func:`_binned_stats_bucket` — each pred is bucketed once against ascending
  thresholds (``searchsorted``) and the counts fall out of a reverse cumulative
  sum over a histogram. The CPU path for ascending thresholds.
"""
import functools
from typing import Optional, Tuple

import torch

__all__ = ["binned_stat_scores", "KERNEL_LAUNCHES"]

#: Launches of the CUDA kernel in this process (one per call that launched).
KERNEL_LAUNCHES = 0

_TARGET_KINDS = {torch.float32: 0, torch.int32: 1, torch.int64: 2}

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
    """Bucket histogram, O(N*C*log T); needs ascending thresholds.

    ``bucket = searchsorted(thresholds, pred, right=True)`` is the number of
    thresholds <= pred, so ``TP(t)`` is the sum of targets with bucket > t: a
    suffix sum of a ``[C, T+1, 2]`` histogram that carries the weighted and
    the raw counts in one scatter. Float32 sums, as in the JAX package; exact
    while every count stays below 2^24.
    """
    preds = preds.to(torch.float32)
    thresholds = thresholds.to(torch.float32)
    n, c = preds.shape
    t = thresholds.shape[0]
    flat_p = preds.reshape(-1)
    bucket = torch.searchsorted(thresholds, flat_p, right=True)
    # `pred >= thr` is False for NaN: bucket 0, negative at every threshold
    bucket = torch.where(torch.isnan(flat_p), torch.zeros_like(bucket), bucket)
    w = target.to(torch.float32)
    cls = torch.arange(c, device=preds.device).repeat(n)
    vals = torch.stack([w.reshape(-1), torch.ones(n * c, dtype=torch.float32, device=preds.device)], dim=-1)
    hist = torch.zeros((c * (t + 1), 2), dtype=torch.float32, device=preds.device)
    hist.index_add_(0, cls * (t + 1) + bucket, vals)
    hist = hist.reshape(c, t + 1, 2)
    suffix = torch.flip(torch.cumsum(torch.flip(hist, [1]), dim=1), [1])
    tp = suffix[:, 1:, 0]
    cnt = suffix[:, 1:, 1]
    pos = w.sum(0)[:, None]
    return tp, cnt - tp, pos - tp


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _rows_per_block(n: int, c: int, device: torch.device) -> int:
    """Rows each block stages: about four blocks per SM, 32 to 256 rows."""
    sms = _sm_count(device.index)
    class_tiles = -(-c // 32)
    want_x = max(1, (4 * sms) // class_tiles)
    return min(256, max(32, -(-n // want_x)))


def _binned_stats_kernel(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor) -> Stats:
    """The CUDA kernel: int32 counts, FP and FN formed here, cast to float32."""
    global KERNEL_LAUNCHES
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
    device = preds.device
    counts = torch.zeros(2 * c * t + c, dtype=torch.int32, device=device)
    tp, cnt, pos = counts[: c * t].view(c, t), counts[c * t : 2 * c * t].view(c, t), counts[2 * c * t :]
    if n and c and t:
        from metrics_tpu_torch.ops._build import load_library

        lib = load_library()
        with torch.cuda.device(device):
            err = lib.binned_stats_launch(
                preds.data_ptr(), target.data_ptr(), _TARGET_KINDS[target.dtype], thresholds.data_ptr(),
                n, c, t, _rows_per_block(n, c, device),
                tp.data_ptr(), cnt.data_ptr(), pos.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"binned_stats kernel launch failed with CUDA error {err}")
        KERNEL_LAUNCHES += 1
    return tp.to(torch.float32), (cnt - tp).to(torch.float32), (pos[:, None] - tp).to(torch.float32)


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
            kernel (no fallback), a CPU tensor takes the bucket form when the
            thresholds ascend and the compare form otherwise. ``True`` demands
            the kernel and raises on a CPU tensor. ``False`` forces the compare
            form, on either device — the oracle the kernel is held against.

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
    thr = thresholds.to(torch.float32)
    if bool(torch.all(thr[1:] >= thr[:-1])):
        return _binned_stats_bucket(preds, target, thresholds)
    return _binned_stats_compare(preds, target, thresholds)
