"""Deprecated alias for :func:`metrics_tpu_torch.functional.text.bleu.bleu_score`
(counterpart of ``metrics_tpu/functional/nlp.py``)."""
from typing import Sequence
from warnings import warn

import torch

from metrics_tpu_torch.functional.text.bleu import bleu_score as _bleu_score


def bleu_score(
    reference_corpus: Sequence[Sequence[Sequence[str]]],
    translate_corpus: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
) -> torch.Tensor:
    """Deprecated — use :func:`metrics_tpu_torch.functional.text.bleu.bleu_score`.

    Example:
        >>> import warnings
        >>> from metrics_tpu_torch.functional.nlp import bleu_score
        >>> translate_corpus = ["the cat is on the mat".split()]
        >>> reference_corpus = [["there is a cat on the mat".split(), "a cat is on the mat".split()]]
        >>> with warnings.catch_warnings():
        ...     warnings.simplefilter("ignore")
        ...     print(round(float(bleu_score(reference_corpus, translate_corpus)), 4))
        0.7598
    """
    warn(
        "Function `functional.nlp.bleu_score` is deprecated. "
        "Use `functional.text.bleu.bleu_score` instead.",
        DeprecationWarning,
    )
    return _bleu_score(reference_corpus, translate_corpus, n_gram, smooth)
