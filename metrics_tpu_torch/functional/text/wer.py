"""Word error rate — functional layer.

Counterpart of ``metrics_tpu/functional/text/wer.py``. String work stays on
the host: tokens are interned to int ids and each row of the edit-distance
DP is one numpy prefix-min scan. The two counters are float32, as in the
JAX package; the functional's value is a host tensor (nothing of it runs on
a device), and the module keeps its counters on its device.
"""
from typing import List, Optional, Tuple, Union

import numpy as np
import torch


def _edit_distance(prediction_tokens: List[str], reference_tokens: List[str]) -> int:
    """Levenshtein distance between token sequences (vectorized rows).

    Row recurrence: ``cur[j] = min(prev[j]+1, prev[j-1]+sub_j, cur[j-1]+1)``.
    The last term is a running prefix-min: ``cur = accmin(cand - j) + j`` with
    ``cand`` the elementwise min of the first two — one numpy scan per row.
    """
    if not prediction_tokens:
        return len(reference_tokens)
    if not reference_tokens:
        return len(prediction_tokens)
    vocab = {t: i for i, t in enumerate(dict.fromkeys(prediction_tokens + reference_tokens))}
    a = np.asarray([vocab[t] for t in prediction_tokens])
    b = np.asarray([vocab[t] for t in reference_tokens])
    n = b.size
    idx = np.arange(n + 1)
    prev = idx.copy()
    for i in range(1, a.size + 1):
        cand = np.empty(n + 1, dtype=np.int64)
        cand[0] = i
        cand[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        prev = np.minimum.accumulate(cand - idx) + idx
    return int(prev[-1])


def _wer_update(predictions: Union[str, List[str]], references: Union[str, List[str]]) -> Tuple[int, int]:
    """Per-batch statistics on the host: (summed edit operations, total
    reference words)."""
    if isinstance(predictions, str):
        predictions = [predictions]
    if isinstance(references, str):
        references = [references]
    if len(predictions) != len(references):
        raise ValueError(
            f"Number of predictions ({len(predictions)}) and references "
            f"({len(references)}) must be the same"
        )
    errors = 0
    total = 0
    for prediction, reference in zip(predictions, references):
        prediction_tokens = prediction.split()
        reference_tokens = reference.split()
        errors += _edit_distance(prediction_tokens, reference_tokens)
        total += len(reference_tokens)
    return errors, total


def _wer_compute(errors: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return errors / total


def wer(
    predictions: Union[str, List[str]],
    references: Union[str, List[str]],
    concatenate_texts: Optional[bool] = None,  # deprecated (reference v0.6); remove in v0.7
) -> torch.Tensor:
    """Word error rate: ``(S + D + I) / N`` over all reference words.

    Args:
        predictions: transcription(s) to score.
        references: reference(s) for each input.
        concatenate_texts: deprecated no-op, as in the JAX package: the
            counter accumulation is equivalent either way; only the
            deprecation warning remains.

    Example:
        >>> predictions = ["this is the prediction", "there is an other sample"]
        >>> references = ["this is the reference", "there is another one"]
        >>> float(wer(predictions=predictions, references=references))
        0.5
    """
    if concatenate_texts is not None:
        import warnings

        warnings.warn(
            "`concatenate_texts` has been deprecated in v0.6 and it will be removed in v0.7",
            DeprecationWarning,
        )
    errors, total = _wer_update(predictions, references)
    return _wer_compute(torch.tensor(errors, dtype=torch.float32), torch.tensor(total, dtype=torch.float32))
