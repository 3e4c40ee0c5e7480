"""CalibrationError module metric.

Counterpart of ``metrics_tpu/classification/calibration_error.py``: top-1
confidences and their correctness accumulate as "cat" states.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.calibration_error import _ce_compute, _ce_update
from metrics_tpu_torch.utils.data import _linspace_like_reference, dim_zero_cat


class CalibrationError(Metric):
    r"""Top-label calibration error: how far predicted confidence is from
    realized accuracy, binned by confidence.

    Each sample's top-class confidence lands in one of ``n_bins`` equal
    bins; per bin the gap :math:`|\text{acc} - \text{conf}|` is weighted by
    the bin's population and reduced by ``norm``: ``"l1"`` the Expected
    Calibration Error (ECE), ``"l2"`` its root-mean-square variant,
    ``"max"`` the worst bin (MCE).

    Args:
        n_bins: number of equal-width confidence bins.
        norm: ``"l1"`` / ``"l2"`` / ``"max"`` as above.
        compute_on_step / dist_sync_on_step / process_group / device: see
            :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CalibrationError
        >>> ece = CalibrationError(n_bins=3, device="cpu")
        >>> ece.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> round(float(ece.compute()), 4)
        0.1375
    """

    DISTANCES = {"l1", "l2", "max"}

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
        compute_on_step: bool = False,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            device=device,
        )
        if norm not in self.DISTANCES:
            raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
        self.n_bins = n_bins
        self.norm = norm
        # the JAX package's jnp.linspace(0, 1, n_bins + 1), bit for bit; kept
        # on the host, and out of dtype casts, as the JAX metric keeps it
        self.bin_boundaries = _linspace_like_reference(n_bins + 1)
        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:  # type: ignore[override]
        confidences, accuracies = _ce_update(preds, target)
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)

    def compute(self) -> torch.Tensor:
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        # compute writes no attribute (the JAX metric sets the boundaries in
        # __init__ alone): the device copy is local
        bounds = self.bin_boundaries.to(confidences.device)
        return _ce_compute(confidences, accuracies, bounds, norm=self.norm)
