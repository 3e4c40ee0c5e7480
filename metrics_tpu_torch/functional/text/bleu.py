"""BLEU score — functional layer.

Counterpart of ``metrics_tpu/functional/text/bleu.py``. N-gram counting runs
on the host; the per-order numerator and denominator and the two length
counters are float32, as in the JAX package, and the geometric mean and
brevity penalty are torch ops on them wherever they live. The functional's
value is a host tensor.
"""
from collections import Counter
from typing import Sequence, Tuple

import numpy as np
import torch


def _ngram_counts(tokens: Sequence[str], n_gram: int) -> Counter:
    """Counts of every 1..n_gram-gram in the token sequence."""
    if any(isinstance(token, torch.Tensor) for token in tokens):
        # a tensor hashes by identity, so its n-grams would never match; the
        # JAX package's arrays do not hash at all
        raise TypeError("unhashable type: 'Tensor': BLEU counts n-grams of hashable tokens, such as strings")
    counts: Counter = Counter()
    for order in range(1, n_gram + 1):
        for start in range(len(tokens) - order + 1):
            counts[tuple(tokens[start : start + order])] += 1
    return counts


def _bleu_score_update(
    reference_corpus: Sequence[Sequence[Sequence[str]]],
    translate_corpus: Sequence[Sequence[str]],
    n_gram: int = 4,
) -> np.ndarray:
    """Per-batch statistics on the host, as one float32 ``[2 * n_gram + 2]``
    array: numerator ``[n_gram]``, denominator ``[n_gram]``, trans_len,
    ref_len (split with :func:`_split_stats`).

    Clipped n-gram hits per order against the per-reference max count
    (``Counter |`` union), closest-length reference for the brevity penalty.
    """
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    trans_len = 0
    ref_len = 0
    for translation, references in zip(translate_corpus, reference_corpus):
        trans_len += len(translation)
        len_diffs = [abs(len(translation) - len(ref)) for ref in references]
        ref_len += len(references[len_diffs.index(min(len_diffs))])
        translation_counts = _ngram_counts(translation, n_gram)
        reference_counts: Counter = Counter()
        for ref in references:
            reference_counts |= _ngram_counts(ref, n_gram)
        clipped = translation_counts & reference_counts
        for ngram, cnt in clipped.items():
            numerator[len(ngram) - 1] += cnt
        for ngram, cnt in translation_counts.items():
            denominator[len(ngram) - 1] += cnt
    return np.concatenate([numerator, denominator, [trans_len, ref_len]]).astype(np.float32)


def _split_stats(stats: torch.Tensor, n_gram: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(numerator, denominator, trans_len, ref_len) of a stats vector."""
    return stats[:n_gram], stats[n_gram : 2 * n_gram], stats[2 * n_gram], stats[2 * n_gram + 1]


def _bleu_score_compute(
    trans_len: torch.Tensor,
    ref_len: torch.Tensor,
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    n_gram: int = 4,
    smooth: bool = False,
) -> torch.Tensor:
    """Geometric mean of n-gram precisions times the brevity penalty."""
    if smooth:
        precision = (numerator + 1.0) / (denominator + 1.0)
        precision = torch.cat([(numerator[0] / denominator[0])[None], precision[1:]])
    else:
        precision = numerator / denominator
    geometric_mean = torch.exp(torch.sum(torch.log(precision) / n_gram))
    one = torch.ones((), dtype=geometric_mean.dtype, device=geometric_mean.device)
    brevity_penalty = torch.where(trans_len > ref_len, one, torch.exp(1.0 - ref_len / trans_len))
    # zero score when any order has no hits (as the JAX package)
    return torch.where(torch.min(numerator) == 0.0, torch.zeros_like(one), brevity_penalty * geometric_mean)


def bleu_score(
    reference_corpus: Sequence[Sequence[Sequence[str]]],
    translate_corpus: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
) -> torch.Tensor:
    """BLEU score of machine-translated text against one or more references.

    Args:
        reference_corpus: per-sample list of tokenized reference translations.
        translate_corpus: list of tokenized candidate translations.
        n_gram: maximum n-gram order (1-4 typical).
        smooth: add-one smoothing for orders above 1.

    Example:
        >>> translate_corpus = ['the cat is on the mat'.split()]
        >>> reference_corpus = [['there is a cat on the mat'.split(), 'a cat is on the mat'.split()]]
        >>> round(float(bleu_score(reference_corpus, translate_corpus)), 4)
        0.7598
    """
    if len(translate_corpus) != len(reference_corpus):
        raise ValueError(f"Corpus has different size {len(translate_corpus)} != {len(reference_corpus)}")
    stats = torch.from_numpy(_bleu_score_update(reference_corpus, translate_corpus, n_gram))
    numerator, denominator, trans_len, ref_len = _split_stats(stats, n_gram)
    return _bleu_score_compute(trans_len, ref_len, numerator, denominator, n_gram, smooth)
