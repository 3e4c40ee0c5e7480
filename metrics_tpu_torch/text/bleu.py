"""BLEUScore module metric.

Counterpart of ``metrics_tpu/text/bleu.py``: n-grams are counted on the
host; the per-order numerator and denominator and the two length counters
are float32 sum states on the metric's device, as the JAX package's.
"""
from typing import Any, Callable, Optional, Sequence, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _split_stats


class BLEUScore(Metric):
    """BLEU score accumulated over a streaming corpus.

    Args:
        n_gram: maximum n-gram order.
        smooth: add-one smoothing for orders above 1.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> from metrics_tpu_torch import BLEUScore
        >>> translate_corpus = ['the cat is on the mat'.split()]
        >>> reference_corpus = [['there is a cat on the mat'.split(), 'a cat is on the mat'.split()]]
        >>> metric = BLEUScore(device="cpu")
        >>> round(float(metric(reference_corpus, translate_corpus)), 4)
        0.7598
    """

    is_differentiable = False

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
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
        self.n_gram = n_gram
        self.smooth = smooth
        self.add_state("trans_len", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("ref_len", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(n_gram), dist_reduce_fx="sum")

    def update(  # type: ignore[override]
        self,
        reference_corpus: Sequence[Sequence[Sequence[str]]],
        translate_corpus: Sequence[Sequence[str]],
    ) -> None:
        # one host-to-device copy of the batch's 2 * n_gram + 2 statistics
        stats = torch.from_numpy(_bleu_score_update(reference_corpus, translate_corpus, self.n_gram)).to(self.device)
        numerator, denominator, trans_len, ref_len = _split_stats(stats, self.n_gram)
        self.numerator = self.numerator + numerator
        self.denominator = self.denominator + denominator
        self.trans_len = self.trans_len + trans_len
        self.ref_len = self.ref_len + ref_len

    def compute(self) -> torch.Tensor:
        return _bleu_score_compute(
            self.trans_len, self.ref_len, self.numerator, self.denominator, self.n_gram, self.smooth
        )
