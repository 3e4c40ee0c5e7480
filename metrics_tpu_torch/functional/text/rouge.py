"""ROUGE score — functional layer.

Counterpart of ``metrics_tpu/functional/text/rouge.py``. All string work
(normalization, stemming, n-gram and LCS matching) runs on the host and
gives per-sentence precision, recall and F1 as Python floats; the module
appends them as float32 cat states, and the functional's means are host
float32 tensors.

Stemming and ``rougeLsum`` need no nltk: this module keeps its own copy of
the JAX package's classic Porter (1980) stemmer and regex sentence
splitter, and makes the same choice: nltk's ``PorterStemmer`` and
``sent_tokenize`` when nltk is importable, the built-in ones otherwise, and
the regex splitter when nltk's ``punkt`` data is missing (``LookupError``).
"""
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    **{f"rouge{n}": n for n in range(1, 10)},
    "rougeL": "L",
    "rougeLsum": "Lsum",
}


# ---------------------------------------------------------------------------
# built-in Porter stemmer (Porter, 1980 — "An algorithm for suffix stripping")
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC (vowel-consonant) transitions in the stem."""
    m = 0
    prev_cons = None
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if prev_cons is False and cons:
            m += 1
        prev_cons = cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _is_cons(word, len(word) - 1)


def _ends_cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
        and word[-1] not in "wxy"
    )


def _replace_suffix(word: str, suffix: str, repl: str, min_measure: int) -> Optional[str]:
    if word.endswith(suffix):
        stem = word[: len(word) - len(suffix)]
        if _measure(stem) > min_measure:
            return stem + repl
    return None


_STEP2_RULES = (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"), ("eli", "e"),
    ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
    ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
    ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
)
_STEP3_RULES = (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
)
_STEP4_SUFFIXES = (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment",
    "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
)


class PorterStemmer:
    """Classic Porter stemmer; drop-in for nltk's when nltk is unavailable."""

    def stem(self, word: str) -> str:
        if len(word) <= 2:
            return word
        word = self._step1a(word)
        word = self._step1b(word)
        word = self._step1c(word)
        word = self._step2(word)
        word = self._step3(word)
        word = self._step4(word)
        word = self._step5(word)
        return word

    @staticmethod
    def _step1a(w: str) -> str:
        if w.endswith("sses"):
            return w[:-2]
        if w.endswith("ies"):
            return w[:-2]
        if w.endswith("ss"):
            return w
        if w.endswith("s"):
            return w[:-1]
        return w

    @staticmethod
    def _step1b(w: str) -> str:
        if w.endswith("eed"):
            return w[:-1] if _measure(w[:-3]) > 0 else w
        fired = None
        if w.endswith("ed") and _has_vowel(w[:-2]):
            fired = w[:-2]
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            fired = w[:-3]
        if fired is None:
            return w
        w = fired
        if w.endswith(("at", "bl", "iz")):
            return w + "e"
        if _ends_double_cons(w) and w[-1] not in "lsz":
            return w[:-1]
        if _measure(w) == 1 and _ends_cvc(w):
            return w + "e"
        return w

    @staticmethod
    def _step1c(w: str) -> str:
        if w.endswith("y") and _has_vowel(w[:-1]):
            return w[:-1] + "i"
        return w

    @staticmethod
    def _step2(w: str) -> str:
        for suffix, repl in _STEP2_RULES:
            out = _replace_suffix(w, suffix, repl, 0)
            if out is not None:
                return out
        return w

    @staticmethod
    def _step3(w: str) -> str:
        for suffix, repl in _STEP3_RULES:
            out = _replace_suffix(w, suffix, repl, 0)
            if out is not None:
                return out
        return w

    @staticmethod
    def _step4(w: str) -> str:
        for suffix in _STEP4_SUFFIXES:
            if w.endswith(suffix):
                stem = w[: len(w) - len(suffix)]
                if _measure(stem) > 1:
                    if suffix == "ion" and not stem.endswith(("s", "t")):
                        continue
                    return stem
                return w
        return w

    @staticmethod
    def _step5(w: str) -> str:
        if w.endswith("e"):
            stem = w[:-1]
            m = _measure(stem)
            if m > 1 or (m == 1 and not _ends_cvc(stem)):
                w = stem
        if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
            w = w[:-1]
        return w


def _get_stemmer() -> Any:
    if _NLTK_AVAILABLE:
        import nltk

        return nltk.stem.porter.PorterStemmer()
    return PorterStemmer()


def _split_sentences(text: str) -> str:
    """Newline-join sentences for rougeLsum: nltk's punkt tokenizer when
    available, a regex split on sentence-final punctuation otherwise."""
    text = re.sub("<n>", "", text)  # pegasus newline token
    if _NLTK_AVAILABLE:
        import nltk

        try:
            return "\n".join(nltk.sent_tokenize(text))
        except LookupError:
            pass
    sentences = re.split(r"(?<=[.!?])\s+", text.strip())
    return "\n".join(s for s in sentences if s)


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def _normalize_and_tokenize_text(text: str, stemmer: Optional[Any] = None) -> List[str]:
    """Lowercase alphanumeric tokens, optional stemming of words >3 chars
    (rouge-score's tokenize)."""
    text = re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and re.match(r"^[a-z0-9]+$", x))]


def _prf(hits: float, pred_len: int, target_len: int) -> Dict[str, float]:
    precision = hits / pred_len
    recall = hits / target_len
    if precision == recall == 0.0:
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    fmeasure = 2 * precision * recall / (precision + recall)
    return dict(precision=precision, recall=recall, fmeasure=fmeasure)


def _rouge_n_score(pred: List[str], target: List[str], n_gram: int) -> Dict[str, float]:
    def ngrams(tokens: List[str]) -> Counter:
        return Counter(tuple(tokens[i : i + n_gram]) for i in range(len(tokens) - n_gram + 1))

    pred_ngrams, target_ngrams = ngrams(pred), ngrams(target)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return _prf(0.0, 1, 1)
    hits = sum((pred_ngrams & target_ngrams).values())
    return _prf(hits, max(pred_len, 1), max(target_len, 1))


def _lcs_len(pred: List[str], target: List[str]) -> int:
    """Longest common subsequence length (two-row DP)."""
    vocab = {t: i for i, t in enumerate(dict.fromkeys(pred + target))}
    a = np.asarray([vocab[t] for t in pred])
    b = np.asarray([vocab[t] for t in target])
    prev = np.zeros(b.size + 1, dtype=np.int64)
    for i in range(a.size):
        cur = np.zeros(b.size + 1, dtype=np.int64)
        for j in range(b.size):
            cur[j + 1] = prev[j] + 1 if a[i] == b[j] else max(prev[j + 1], cur[j])
        prev = cur
    return int(prev[-1])


def _rouge_l_score(pred: List[str], target: List[str]) -> Dict[str, float]:
    pred_len, target_len = len(pred), len(target)
    if 0 in (pred_len, target_len):
        return _prf(0.0, 1, 1)
    return _prf(_lcs_len(pred, target), pred_len, target_len)


def _lcs_positions(a: List[str], b: List[str]) -> set:
    """Indices of ``a`` participating in one LCS with ``b`` (backtracked DP)."""
    dp = [[0] * (len(b) + 1) for _ in range(len(a) + 1)]
    for i in range(len(a)):
        for j in range(len(b)):
            dp[i + 1][j + 1] = dp[i][j] + 1 if a[i] == b[j] else max(dp[i][j + 1], dp[i + 1][j])
    positions = set()
    i, j = len(a), len(b)
    while i > 0 and j > 0:
        if a[i - 1] == b[j - 1] and dp[i][j] == dp[i - 1][j - 1] + 1:
            positions.add(i - 1)
            i -= 1
            j -= 1
        elif dp[i - 1][j] >= dp[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return positions


def _rouge_lsum_score(pred_sents: List[List[str]], target_sents: List[List[str]]) -> Dict[str, float]:
    """Summary-level ROUGE-L: union-LCS over sentence pairs with clipping.

    For each target sentence the union of LCS-matched token positions across
    all prediction sentences counts as hits, clipped by corpus-level token
    counts (the rouge-score package's ``_summary_level_lcs``), as the JAX
    package computes it.
    """
    pred_len = sum(len(s) for s in pred_sents)
    target_len = sum(len(s) for s in target_sents)
    if 0 in (pred_len, target_len):
        return _prf(0.0, 1, 1)
    pred_counts = Counter(tok for s in pred_sents for tok in s)
    target_counts = Counter(tok for s in target_sents for tok in s)
    hits = 0
    for target_sent in target_sents:
        union: set = set()
        for pred_sent in pred_sents:
            union |= _lcs_positions(target_sent, pred_sent)
        for pos in union:
            token = target_sent[pos]
            if pred_counts[token] > 0 and target_counts[token] > 0:
                hits += 1
                pred_counts[token] -= 1
                target_counts[token] -= 1
    return _prf(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    targets: Sequence[str],
    rouge_keys_values: List[Union[int, str]],
    stemmer: Optional[Any] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sentence P/R/F for every requested rouge variant."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}
    for pred_raw, target_raw in zip(preds, targets):
        pred = _normalize_and_tokenize_text(pred_raw, stemmer)
        target = _normalize_and_tokenize_text(target_raw, stemmer)
        if "Lsum" in rouge_keys_values:
            # per-sentence token lists (normalization would destroy the
            # newline boundaries, so split first, tokenize each sentence)
            pred_sents = [_normalize_and_tokenize_text(s, stemmer) for s in _split_sentences(pred_raw).split("\n")]
            target_sents = [
                _normalize_and_tokenize_text(s, stemmer) for s in _split_sentences(target_raw).split("\n")
            ]
        for key in rouge_keys_values:
            if isinstance(key, int):
                score = _rouge_n_score(pred, target, key)
            elif key == "Lsum":
                score = _rouge_lsum_score(pred_sents, target_sents)
            else:
                score = _rouge_l_score(pred, target)
            results[key].append(score)
    return results


def _rouge_score_compute(sentence_results: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Mean over the accumulated per-sentence float32 scores (``[N]`` each);
    0.0 where none were accumulated."""
    return {
        key: torch.mean(scores) if scores.numel() else torch.zeros((), device=scores.device)
        for key, scores in sentence_results.items()
    }


def _parse_rouge_keys(rouge_keys: Union[str, Tuple[str, ...]]) -> Tuple[Tuple[str, ...], List[Union[int, str]]]:
    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    return rouge_keys, [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]


def rouge_score(
    preds: Union[str, List[str]],
    targets: Union[str, List[str]],
    use_stemmer: bool = False,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
) -> Dict[str, torch.Tensor]:
    """ROUGE score for automatic summarization.

    Args:
        preds: predicted sentence(s).
        targets: target sentence(s).
        use_stemmer: Porter-stem tokens >3 chars before matching.
        rouge_keys: which variants — ``rouge1``..``rouge9``, ``rougeL``, ``rougeLsum``.

    Returns:
        dict with ``{key}_precision/_recall/_fmeasure`` entries.

    Example:
        >>> targets = "Is your name John"
        >>> preds = "My name is John"
        >>> scores = rouge_score(preds, targets, rouge_keys="rouge1")
        >>> float(scores["rouge1_fmeasure"])
        0.75
    """
    stemmer = _get_stemmer() if use_stemmer else None
    _, rouge_keys_values = _parse_rouge_keys(rouge_keys)
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(targets, str):
        targets = [targets]

    sentence_results = _rouge_score_update(preds, targets, rouge_keys_values, stemmer=stemmer)
    output: Dict[str, List[float]] = {}
    for key, metrics in sentence_results.items():
        for metric in metrics:
            for kind, value in metric.items():
                output.setdefault(f"rouge{key}_{kind}", []).append(value)
    return _rouge_score_compute({k: torch.tensor(v, dtype=torch.float32) for k, v in output.items()})
