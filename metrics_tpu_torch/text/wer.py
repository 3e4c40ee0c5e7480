"""WER module metric.

Counterpart of ``metrics_tpu/text/wer.py``: the edit distance runs on the
host, and the two counters (errors, reference words) are float32 states on
the metric's device, as the JAX package's, sum-reduced across ranks.
"""
from typing import Any, Callable, List, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.wer import _wer_compute, _wer_update


class WER(Metric):
    r"""Word error rate ``(S + D + I) / N`` — substitutions, deletions and
    insertions from the minimum word-level edit distance, over the total
    reference length, accumulated across batches.

    0.0 is perfect; values can exceed 1.0 when hypotheses insert more words
    than the reference has. The counters are float32 (exact below 2**24
    words, as in the JAX package).

    Args:
        concatenate_texts: deprecated no-op kept for API compatibility
            (scores are identical either way).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> from metrics_tpu_torch import WER
        >>> predictions = ["this is the prediction", "there is an other sample"]
        >>> references = ["this is the reference", "there is another one"]
        >>> metric = WER(device="cpu")
        >>> float(metric(predictions, references))
        0.5
    """

    is_differentiable = False

    def __init__(
        self,
        concatenate_texts: Optional[bool] = None,  # deprecated (reference v0.6); remove in v0.7
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        if concatenate_texts is not None:
            import warnings

            warnings.warn(
                "`concatenate_texts` has been deprecated in v0.6 and it will be removed in v0.7",
                DeprecationWarning,
            )
        self.add_state("errors", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(  # type: ignore[override]
        self, predictions: Union[str, List[str]], references: Union[str, List[str]]
    ) -> None:
        errors, total = _wer_update(predictions, references)
        # Python numbers: float32 adds on the device, no host-to-device copy
        self.errors = self.errors + float(errors)
        self.total = self.total + float(total)

    def compute(self) -> torch.Tensor:
        return _wer_compute(self.errors, self.total)
