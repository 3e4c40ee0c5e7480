"""Multiclass confusion-matrix counts of one batch: the int64 ``[nc, nc]``
counts of ``target class * nc + pred class``.

For preds as float scores ``[N, C, *X]`` the pred class is the first maximum
along dim 1, NaN the largest (``torch.argmax``); for integer labels ``[N, *X]``
it is the label where it lies in ``[0, W)``, else 0, and the target ``[N, *X]``
maps by the same rule. ``W`` is the width at which the plain composition
one-hot encodes the labels (``utils/checks.py::_onehot_width``), so 0 is the
argmax of an all-zero one-hot row. A cell at or above ``nc * nc`` is dropped,
as :func:`~metrics_tpu_torch.utils.data._bincount` drops it.

Two implementations, equal bit for bit:

- :func:`_confusion_counts_kernel` — the hand-written CUDA kernel
  (``csrc/confusion_counts.cu``), which replaces no TPU kernel: the JAX
  package computes these counts as an XLA composition of one-hot formatting,
  argmax and a scatter. ``functional/classification/confusion_matrix.py``
  calls it for a (multi-dim) multi-class batch on CUDA. :func:`_plan` picks its
  design, grid and histogram from the shapes alone. The launch is a
  registered op (``metrics_tpu_torch::confusion_counts``) with a fake
  implementation, so that the compiled path's probe sees through it under
  ``FakeTensorMode`` and a CUDA graph capture records the kernel and its
  output memset. ``KERNEL_LAUNCHES`` counts a launch where the op body runs;
  ``core/compiled.py`` takes a capture's count back and adds it again at
  every replay.
- :func:`_confusion_counts_plain` — the same function in torch: an argmax, the
  label rule and :func:`_bincount`. The reference that the tests and
  ``chip_smoke.py`` hold the kernel to; the CPU counts through the
  update's one-hot composition instead.
"""
import contextlib
import functools
from typing import Tuple

import torch

from metrics_tpu_torch.utils.data import _bincount

__all__ = ["KERNEL_LAUNCHES"]

#: Launches of the CUDA kernel in this process (one per call that launched).
KERNEL_LAUNCHES = 0

_PRED_KINDS = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3}
_TARGET_KINDS = {torch.int32: 0, torch.int64: 1}
_DESIGNS = {"planes": 0, "rows": 1, "labels": 2}
_THREADS = 256  # threads per block (kThreads)
_BLOCKS_PER_SM = 4
_ROWS_FROM = 33  # scores [N, C] with C at least this take a group of lanes per row
# opt-in shared memory of a block and of an SM on sm_90 (H100, H200), the one
# target the kernels are built for, and the bytes of a block's left aside
_SMEM_OPTIN = 232448
_SMEM_PER_SM = 233472
_SMEM_RESERVE = 1024
_MAX_CLASSES = 1 << 28  # kMaxClasses: keeps the matrix's byte count in 64 bits
# a block's positions stay below this, so its uint32 shared bins cannot wrap
_BLOCK_POSITIONS = 1 << 30


def _confusion_counts_plain(preds: torch.Tensor, target: torch.Tensor, num_classes: int, width: int) -> torch.Tensor:
    """The kernel's function in torch, on any device."""

    def label_class(x: torch.Tensor) -> torch.Tensor:
        x = x.long()
        return torch.where((x >= 0) & (x < width), x, torch.zeros_like(x))

    pred = torch.argmax(preds, dim=1) if preds.is_floating_point() else label_class(preds)
    cells = label_class(target).reshape(-1) * num_classes + pred.reshape(-1)
    return _bincount(cells, num_classes**2).reshape(num_classes, num_classes)


@functools.lru_cache(maxsize=4096)
def _plan(labels: bool, n: int, c: int, x: int, num_classes: int, sm_count: int) -> Tuple[str, int, int, bool]:
    """``(design, lanes, blocks, shared)`` for the kernel, from the shapes and
    the card alone (no device read).

    Labels take the labels design. Scores take the planes design (a thread
    per position, looping over the C planes) where ``X > 1`` or ``C`` is
    small, else the rows design, with a group of lanes per row: the power of
    two that gives each lane at most about 32 scores, up to a warp. The
    histogram is in shared memory where ``num_classes**2`` uint32 bins fit a
    block's (``shared``), else in global memory. The grid is about one wave,
    ``_BLOCKS_PER_SM`` blocks an SM (fewer where the bins limit an SM's
    blocks), and no more blocks than the work fills; never so few that a
    block counts ``_BLOCK_POSITIONS`` positions.
    """
    bins_bytes = 4 * num_classes**2
    shared = bins_bytes <= _SMEM_OPTIN - _SMEM_RESERVE
    positions = n * x
    if labels:
        design, lanes, threads = "labels", 1, -(-positions // 4)
    elif x > 1 or c < _ROWS_FROM:
        design, lanes, threads = "planes", 1, -(-positions // 4) if x % 4 == 0 else positions
    else:
        design, lanes = "rows", min(32, 1 << (-(-c // 32) - 1).bit_length())
        threads = n * lanes
    per_sm = _BLOCKS_PER_SM
    if shared:
        per_sm = max(1, min(per_sm, _SMEM_PER_SM // (bins_bytes + _SMEM_RESERVE)))
    blocks = max(1, min(-(-threads // _THREADS), sm_count * per_sm), -(-positions // _BLOCK_POSITIONS))
    return design, lanes, blocks, shared


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The op is defined with a ``Library`` fragment rather than
# ``torch.library.custom_op``, which wraps its implementation in
# ``torch._disable_dynamo``: that wrapper's first call imports
# ``torch._dynamo`` (~800 modules, seconds of a process's set-up).
_LIB = torch.library.Library("metrics_tpu_torch", "FRAGMENT")
_LIB.define("confusion_counts(Tensor preds, Tensor target, int num_classes, int width) -> Tensor")


def _confusion_counts_op(preds: torch.Tensor, target: torch.Tensor, num_classes: int, width: int) -> torch.Tensor:
    """One launch of the CUDA kernel on validated, non-empty inputs: the int64
    ``[num_classes, num_classes]`` counts."""
    global KERNEL_LAUNCHES
    from metrics_tpu_torch.ops._build import load_library

    labels = not preds.is_floating_point()
    n = preds.shape[0]
    c = 1 if labels else preds.shape[1]
    x = target.numel() // n
    device = preds.device
    lib = load_library()
    design, lanes, blocks, shared = _plan(labels, n, c, x, num_classes, _sm_count(device.index))
    out = torch.empty((num_classes, num_classes), dtype=torch.int64, device=device)
    # the C entry launches on the current device's context: switch only when
    # the tensors live on another card
    switch = device.index != torch.cuda.current_device()
    with torch.cuda.device(device) if switch else contextlib.nullcontext():
        err = lib.confusion_counts_launch(
            preds.data_ptr(), _PRED_KINDS[preds.dtype], target.data_ptr(), _TARGET_KINDS[target.dtype],
            n, c, x, num_classes, width, _DESIGNS[design], lanes, blocks, int(shared),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"confusion_counts kernel ({design}) launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


_LIB.impl("confusion_counts", _confusion_counts_op, "CUDA")


@torch.library.register_fake("metrics_tpu_torch::confusion_counts", lib=_LIB)
def _confusion_counts_fake(preds: torch.Tensor, target: torch.Tensor, num_classes: int, width: int) -> torch.Tensor:
    return preds.new_empty((num_classes, num_classes), dtype=torch.int64)


def _confusion_counts_kernel(preds: torch.Tensor, target: torch.Tensor, num_classes: int, width: int) -> torch.Tensor:
    """The int64 ``[num_classes, num_classes]`` confusion counts of one batch
    by the CUDA kernel, after the checks of what it takes (types, shapes and
    ranges first, then devices and layout); no launch for an empty batch.

    Args:
        preds: float scores ``[N, C, *X]`` or integer labels ``[N, *X]``
            (float32/float64 or int32/int64, contiguous, on CUDA).
        target: integer labels ``[N, *X]`` (int32 or int64).
        num_classes: ``nc``: the counts' rows and columns.
        width: ``W``: a label outside ``[0, W)`` counts as class 0.
    """
    if preds.dtype not in _PRED_KINDS or target.dtype not in _TARGET_KINDS:
        raise ValueError(
            "confusion_counts kernel: `preds` must be float32, float64, int32 or int64 and `target` int32 or "
            f"int64, got {preds.dtype} and {target.dtype}"
        )
    labels = not preds.is_floating_point()
    want = tuple(preds.shape) if labels else tuple(preds.shape[:1] + preds.shape[2:])
    if (not labels and preds.ndim < 2) or tuple(target.shape) != want:
        raise ValueError(
            "confusion_counts kernel: expected scores [N, C, *X] or labels [N, *X] with target [N, *X], got "
            f"{tuple(preds.shape)} and {tuple(target.shape)}"
        )
    if not (1 <= num_classes <= _MAX_CLASSES and 1 <= width < 2**31 and (labels or 1 <= preds.shape[1] < 2**31)):
        raise ValueError(
            f"confusion_counts kernel: num_classes={num_classes}, width={width} or C out of the kernel's range"
        )
    for name, t in (("preds", preds), ("target", target)):
        if not t.is_cuda:
            raise ValueError(f"confusion_counts kernel: `{name}` must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"confusion_counts kernel: `{name}` must be contiguous")
    if preds.device != target.device:
        raise ValueError(f"confusion_counts kernel: tensors on different devices ({preds.device}, {target.device})")
    if target.numel() == 0:
        return torch.zeros((num_classes, num_classes), dtype=torch.int64, device=preds.device)
    return torch.ops.metrics_tpu_torch.confusion_counts(preds, target, num_classes, width)

