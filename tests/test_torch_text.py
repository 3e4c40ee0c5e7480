"""The port's WER, BLEU and ROUGE against the JAX package, on the CPU.

The same seeded strings go through both packages. Every count is exact:
WER's and BLEU's float32 counters hold integers, and WER's value is one
float32 division of them, so it is exact too. BLEU's value goes through a
float32 ``log`` per order and one ``exp``, which XLA and PyTorch may round
one ulp apart: ``BLEU_RTOL = 4 * 2**-24`` (~2.4e-7). ROUGE's per-sentence
precision, recall and F1 are Python floats rounded once to float32 in both
packages, so the states are exact; the means are float32 sums over N
sentences in another order, off by at most ``log2(N) * 2**-24`` of the
mean: ``ROUGE_MEAN_RTOL = 8 * 2**-24`` for the N <= 64 here.

Stemmers and splitters (ROUGE): nltk is importable here, so both packages
stem with nltk's ``PorterStemmer``; its ``punkt`` data is absent, so
``rougeLsum`` splits sentences with the regex in both. On a machine without
nltk both run their built-in Porter: the stemmed cases run twice, as found
and with ``_NLTK_AVAILABLE`` patched to ``False`` in both packages.
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional.nlp as ref_nlp
import metrics_tpu.functional.text.rouge as ref_rouge
import metrics_tpu_torch as port
import metrics_tpu_torch.functional.nlp as port_nlp
import metrics_tpu_torch.functional.text.rouge as port_rouge
from metrics_tpu.functional.text import bleu_score as ref_bleu
from metrics_tpu.functional.text import rouge_score as ref_rouge_score
from metrics_tpu.functional.text import wer as ref_wer
from metrics_tpu_torch.functional.text import bleu_score as port_bleu
from metrics_tpu_torch.functional.text import rouge_score as port_rouge_score
from metrics_tpu_torch.functional.text import wer as port_wer

BLEU_RTOL = 4 * 2.0 ** -24
ROUGE_MEAN_RTOL = 8 * 2.0 ** -24
CPU = {"device": "cpu"}
ROUGE_KEYS = ("rouge1", "rouge2", "rouge3", "rougeL", "rougeLsum")
SUFFIXES = ("", "", "s", "ing", "ed", "ation", "ness", "ly", "ies", "ational", "fulness")


def _vocab(rng, n=300):
    letters = np.array(list("abcdefghilmnoprstuy"))
    stems = {"".join(rng.choice(letters, rng.randint(2, 8))) for _ in range(n)}
    return sorted(s + SUFFIXES[rng.randint(len(SUFFIXES))] for s in stems)


def _pairs(seed, n, words=12):
    """n (hypothesis, reference) word lists: each reference a seeded draw,
    its hypothesis with ~15% substitutions, deletions and insertions."""
    rng = np.random.RandomState(seed)
    vocab = _vocab(rng)
    out = []
    for _ in range(n):
        refw = list(rng.choice(vocab, rng.randint(1, 2 * words)))
        hyp = []
        for w in refw:
            r = rng.rand()
            if r < 0.05:
                continue
            hyp.append(rng.choice(vocab) if r < 0.10 else w)
            if r > 0.95:
                hyp.append(rng.choice(vocab))
        out.append((hyp, refw))
    return out


def _summary(rng, words, sentences):
    ends = ".!?"
    return " ".join(
        " ".join(rng.choice(words, rng.randint(3, 12))).capitalize() + ends[rng.randint(3)]
        for _ in range(sentences)
    )


def _summaries(seed, n):
    rng = np.random.RandomState(seed)
    vocab = _vocab(rng, 120)
    preds, targets = [], []
    for _ in range(n):
        target = _summary(rng, vocab, rng.randint(1, 4))
        tokens = target.split()
        keep = [w for w in tokens if rng.rand() > 0.3] or tokens[:1]
        preds.append(" ".join(keep) + " " + _summary(rng, vocab, 1))
        targets.append(target)
    return preds, targets


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# WER
# ---------------------------------------------------------------------------


def _wer_batches():
    pairs = _pairs(0, 40)
    hyps, refs = [" ".join(h) for h, _ in pairs], [" ".join(r) for _, r in pairs]
    return [(hyps[:25], refs[:25]), (hyps[25:], refs[25:])]


def test_wer_functional_is_exact():
    for hyps, refs in _wer_batches():
        got = port_wer(hyps, refs)
        assert got.dtype == torch.float32
        assert _np(got) == np.asarray(ref_wer(hyps, refs))
    assert float(port_wer("hello world", "hello there world")) == float(ref_wer("hello world", "hello there world"))


def test_wer_module_is_exact():
    jm, pm = ref.WER(), port.WER(**CPU)
    for hyps, refs in _wer_batches():
        assert _np(pm(hyps, refs)) == np.asarray(jm(hyps, refs))
    for name in ("errors", "total"):
        assert getattr(pm, name).dtype == torch.float32
        assert _np(getattr(pm, name)) == np.asarray(getattr(jm, name))
    assert _np(pm.compute()) == np.asarray(jm.compute())


def test_wer_errors_and_deprecation():
    with pytest.raises(ValueError, match="must be the same"):
        port_wer(["a b"], ["a", "b"])
    with pytest.raises(ValueError):
        ref_wer(["a b"], ["a", "b"])
    with pytest.warns(DeprecationWarning, match="`concatenate_texts` has been deprecated in v0.6"):
        port_wer(["a b"], ["a c"], concatenate_texts=True)
    with pytest.warns(DeprecationWarning, match="`concatenate_texts` has been deprecated in v0.6"):
        m = port.WER(concatenate_texts=True, **CPU)
    m.update(["hello world"], ["hello world"])
    assert float(m.compute()) == 0.0


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------


def _bleu_batches():
    pairs = _pairs(1, 40, words=20)
    rng = np.random.RandomState(2)
    refs = [[r] + ([h[::-1]] if rng.rand() < 0.5 else []) for h, r in pairs]
    hyps = [h for h, _ in pairs]
    return [(refs[:20], hyps[:20]), (refs[20:], hyps[20:])]


def _assert_bleu_close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=BLEU_RTOL, atol=0)


@pytest.mark.parametrize("n_gram", [1, 2, 3, 4])
@pytest.mark.parametrize("smooth", [False, True])
def test_bleu_functional_matches_reference(n_gram, smooth):
    refs, hyps = _bleu_batches()[0]
    _assert_bleu_close(port_bleu(refs, hyps, n_gram, smooth), ref_bleu(refs, hyps, n_gram, smooth))


def test_bleu_zero_order_gives_zero():
    refs, hyps = [["a b c d".split()]], ["a x b y".split()]
    assert float(port_bleu(refs, hyps)) == float(ref_bleu(refs, hyps)) == 0.0


@pytest.mark.parametrize("smooth", [False, True])
def test_bleu_module_counts_are_exact(smooth):
    jm, pm = ref.BLEUScore(smooth=smooth), port.BLEUScore(smooth=smooth, **CPU)
    for refs, hyps in _bleu_batches():
        _assert_bleu_close(pm(refs, hyps), jm(refs, hyps))
    for name in ("numerator", "denominator", "trans_len", "ref_len"):
        assert getattr(pm, name).dtype == torch.float32
        np.testing.assert_array_equal(_np(getattr(pm, name)), np.asarray(getattr(jm, name)))
    _assert_bleu_close(pm.compute(), jm.compute())


def test_bleu_errors_and_deprecated_alias():
    refs, hyps = _bleu_batches()[0]
    with pytest.raises(ValueError, match="Corpus has different size"):
        port_bleu(refs, hyps[:-1])
    with pytest.raises(ValueError, match="Corpus has different size"):
        ref_bleu(refs, hyps[:-1])
    with pytest.warns(DeprecationWarning, match="functional.nlp.bleu_score` is deprecated"):
        got = port_nlp.bleu_score(refs, hyps, 2, True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_nlp.bleu_score(refs, hyps, 2, True)
    _assert_bleu_close(got, want)


# ---------------------------------------------------------------------------
# ROUGE
# ---------------------------------------------------------------------------


@pytest.fixture(params=["nltk as found", "built-in"])
def stemmers(request, monkeypatch):
    """Both packages' stemmer and splitter choice: as found here (nltk's
    stemmer, the regex splitter for want of punkt), then the built-in
    Porter and the regex splitter, as on a machine without nltk."""
    if request.param == "built-in":
        monkeypatch.setattr(ref_rouge, "_NLTK_AVAILABLE", False)
        monkeypatch.setattr(port_rouge, "_NLTK_AVAILABLE", False)
    return request.param


def test_stemmer_choice_follows_nltk(stemmers):
    stemmer = port_rouge._get_stemmer()
    assert type(stemmer).__module__.startswith("nltk") == (stemmers == "nltk as found")
    assert type(ref_rouge._get_stemmer()).__name__ == type(stemmer).__name__
    text = "The cats sat. Dogs ran! Did they? Yes"
    assert port_rouge._split_sentences(text) == ref_rouge._split_sentences(text) == \
        "The cats sat.\nDogs ran!\nDid they?\nYes"


@pytest.mark.parametrize("word", ["caresses", "ponies", "relational", "hopefulness", "generalizations",
                                  "adjustable", "controlling", "agreed", "happy", "running", "sky"])
def test_builtin_porter_matches_reference(word):
    assert port_rouge.PorterStemmer().stem(word) == ref_rouge.PorterStemmer().stem(word)


@pytest.mark.parametrize("use_stemmer", [False, True])
def test_rouge_functional_matches_reference(stemmers, use_stemmer):
    preds, targets = _summaries(3, 24)
    want = ref_rouge_score(preds, targets, use_stemmer=use_stemmer, rouge_keys=ROUGE_KEYS)
    got = port_rouge_score(preds, targets, use_stemmer=use_stemmer, rouge_keys=ROUGE_KEYS)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(v), rtol=ROUGE_MEAN_RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("use_stemmer", [False, True])
def test_rouge_module_sentences_are_exact(stemmers, use_stemmer):
    """Each update appends one [batch] tensor per state; concatenated, the
    states equal the JAX package's per-sentence lists value for value."""
    preds, targets = _summaries(4, 40)
    jm = ref.ROUGEScore(use_stemmer=use_stemmer, rouge_keys=ROUGE_KEYS)
    pm = port.ROUGEScore(use_stemmer=use_stemmer, rouge_keys=ROUGE_KEYS, **CPU)
    for sl in (slice(0, 15), slice(15, 16), slice(16, 40)):
        jm.update(preds[sl], targets[sl])
        pm.update(preds[sl], targets[sl])
    for key in ROUGE_KEYS:
        for kind in ("fmeasure", "precision", "recall"):
            state = getattr(pm, f"{key}_{kind}")
            assert len(state) == 3 and all(s.dtype == torch.float32 for s in state)
            want = np.concatenate([np.atleast_1d(np.asarray(x)) for x in getattr(jm, f"{key}_{kind}")])
            np.testing.assert_array_equal(_np(torch.cat(state)), want, err_msg=f"{key}_{kind}")
    got, want = pm.compute(), jm.compute()
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(v), rtol=ROUGE_MEAN_RTOL, atol=0, err_msg=k)


def test_rouge_single_strings_and_empty_state():
    got = port.ROUGEScore(rouge_keys="rouge1", **CPU)("My name is John", "Is your name John")
    assert float(got["rouge1_fmeasure"]) == 0.75
    m = port.ROUGEScore(**CPU)
    with pytest.warns(UserWarning, match="before the ``update``"):
        out = m.compute()
    assert all(float(v) == 0.0 for v in out.values()) and len(out) == 12


def test_rouge_errors_and_deprecated_kwargs():
    for pkg, kw in ((ref, {}), (port, CPU)):
        with pytest.raises(ValueError, match="Got unknown rouge key rouge0"):
            pkg.ROUGEScore(rouge_keys=("rouge1", "rouge0"), **kw)
    with pytest.raises(ValueError, match="Got unknown rouge key"):
        port_rouge_score("a", "a", rouge_keys="rougeX")
    for key in ("newline_sep", "decimal_places"):
        with pytest.warns(UserWarning, match=f"`{key}` is deprecated in v0.6"):
            port.ROUGEScore(**{key: True}, **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.ROUGEScore(**CPU)
