"""Top-label calibration error (ECE / RMSCE / MCE) — functional layer.

Counterpart of ``metrics_tpu/functional/classification/calibration_error.py``:
one bucketize of the confidences into ``(lower, upper]`` bins and masked bin
means, no loop over bins. The bin boundaries are those of the JAX package's
``jnp.linspace(0, 1, n_bins + 1)`` bit for bit
(``utils/data.py::_linspace_like_reference``); ``torch.linspace`` differs in
6 of the 16 boundaries of the default 15 bins.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_broadcastable, _input_mode
from metrics_tpu_torch.utils.data import _linspace_like_reference
from metrics_tpu_torch.utils.enums import DataType


def _ce_compute(
    confidences: torch.Tensor,
    accuracies: torch.Tensor,
    bin_boundaries: torch.Tensor,
    norm: str = "l1",
    debias: bool = False,
) -> torch.Tensor:
    """Calibration error over (lower, upper] confidence bins."""
    if norm not in {"l1", "l2", "max"}:
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    n_bins = bin_boundaries.shape[0] - 1
    bin_boundaries = bin_boundaries.to(confidences.device)
    # bin i is (b_i, b_{i+1}]; a confidence of exactly 0 falls in no bin
    idx = torch.searchsorted(bin_boundaries, confidences, right=False) - 1
    bins = torch.arange(n_bins, device=confidences.device)
    onehot = (idx.unsqueeze(1) == bins.unsqueeze(0)) & (idx >= 0).unsqueeze(1)  # [N, B]
    count_bin = torch.sum(onehot, dim=0).to(torch.float32)
    safe_count = torch.where(count_bin == 0, torch.ones_like(count_bin), count_bin)
    # a NaN or infinite confidence lies in no bin and adds 0 to every bin's
    # sums, as XLA's select does for the JAX package's bool-mask product (a
    # product would add NaN); it still counts in N below
    conf_bin = torch.sum(torch.where(onehot, confidences.unsqueeze(1), 0.0), dim=0) / safe_count
    acc_bin = torch.sum(torch.where(onehot, accuracies.unsqueeze(1), 0.0), dim=0) / safe_count
    prop_bin = count_bin / confidences.shape[0]
    conf_bin = torch.where(count_bin == 0, torch.zeros_like(conf_bin), conf_bin)
    acc_bin = torch.where(count_bin == 0, torch.zeros_like(acc_bin), acc_bin)
    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return torch.max(torch.abs(acc_bin - conf_bin))
    ce = torch.sum((acc_bin - conf_bin) ** 2 * prop_bin)
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * accuracies.shape[0] - 1)
        ce = ce + torch.sum(torch.nan_to_num(debias_bins))
    return torch.where(ce > 0, torch.sqrt(torch.clamp_min(ce, 0.0)), torch.zeros_like(ce))


def _ce_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 confidences and their correctness, per input mode."""
    mode = _input_mode(preds, target)
    if mode == DataType.BINARY:
        confidences, accuracies = preds, target
    elif mode == DataType.MULTICLASS:
        if preds.ndim < 2:
            # the JAX package's jnp.max(preds, axis=1) raises ValueError here
            raise ValueError(
                f"Calibration error needs probability scores of shape [N, C], got label preds of shape "
                f"{tuple(preds.shape)}."
            )
        confidences = torch.amax(preds, dim=1)
        predictions = torch.argmax(preds, dim=1)
        accuracies = predictions == target
    elif mode == DataType.MULTIDIM_MULTICLASS:
        flat = torch.transpose(preds, 1, -1).reshape(-1, preds.shape[1])
        confidences = torch.amax(flat, dim=1)
        predictions = torch.argmax(flat, dim=1)
        _check_broadcastable(
            tuple(predictions.shape), (target.numel(),),
            "Calibration error needs probability scores of shape [N, C, ...], got label preds",
        )
        accuracies = predictions == target.reshape(-1)
    else:
        raise ValueError(
            f"Calibration error is not well-defined for data with size {preds.shape} and targets {target.shape}."
        )
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def calibration_error(preds: torch.Tensor, target: torch.Tensor, n_bins: int = 15, norm: str = "l1") -> torch.Tensor:
    r"""Top-label calibration error (L1 = ECE, L2 = RMSCE, max = MCE).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import calibration_error
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> round(float(calibration_error(preds, target, n_bins=2, norm="l1")), 4)
        0.29
    """
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
    confidences, accuracies = _ce_update(preds, target)
    return _ce_compute(confidences, accuracies, _linspace_like_reference(n_bins + 1), norm=norm)
