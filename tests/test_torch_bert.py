"""The port's BERT encoder and BERTScore against the JAX package, on the CPU.

A small encoder (2 layers, hidden 64, 2 heads, a 2,000-token vocabulary,
``max_length=16``) is drawn once by the JAX package's ``bert_init`` and
carried across with ``params_from_jax``; the default encoder (the JAX
package's ``BertConfig()``) is drawn by each package's own ``bert_init``, and
is built for one (``num_layers``, ``all_layers``) key only: both packages
compile and draw it again for every key, so ``num_layers`` and
``all_layers`` are covered through a tiny HF checkpoint on the named-model
path, which runs the same forward.

Tolerances:

- ``bert_init``: the port draws the same threefry bits and maps
  them to normals through XLA's own ``ErfInv`` polynomial; ``log1p`` and the
  products' rounding leave the last bits: ``INIT_ULPS = 4`` float32 ulps
  (measured: 95.6% of the default encoder's weights bit-equal, the rest 1 to
  4 ulps, at most 1.5e-8 absolute).
- hidden states: ``HIDDEN_RTOL = 1e-6`` of the layer's largest value (layer
  norm outputs of size ~4; float32 sums of 64-128 products and a softmax in
  another order; measured 2.4e-7 after two layers).
- precision, recall, F1: ``SCORE_ATOL = 2e-6``; means of greedy maxima of
  cosines of unit vectors whose entries differ by ~1e-7 (measured 3.6e-7).
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional.text.bert as ref_bs
from metrics_tpu.models import bert as ref_bert
import metrics_tpu_torch as port
import metrics_tpu_torch.functional.text.bert as port_bs
from metrics_tpu_torch.models import bert as port_bert
from metrics_tpu_torch.utils.device import full_float32

INIT_ULPS, HIDDEN_RTOL, SCORE_ATOL = 4, 1e-6, 2e-6
MAX_LEN = 16
SMALL = dict(vocab_size=2000, hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
             max_position_embeddings=MAX_LEN)
PREDS = ["the quick brown fox jumps", "hello there", "a b c d e f g h i j k l m n o p q", "x", "same same words"]
REFS = ["a quick brown dog jumped", "hello there", "a b c", "y z", "same same words"]
KEYS = ("precision", "recall", "f1")
CPU = {"device": "cpu"}
# the small encoder's vocabulary: the packages' hash tokenizer at its size
REF_TOK = dict(user_tokenizer=ref_bs.SimpleTokenizer(SMALL["vocab_size"], MAX_LEN))
PORT_TOK = dict(user_tokenizer=port_bs.SimpleTokenizer(SMALL["vocab_size"], MAX_LEN))


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="No model specified")
        yield


@pytest.fixture(scope="module")
def small():
    """The JAX params of the small encoder, its jitted forward (compiled
    once per input shape) and the port's encoder holding the same weights."""
    config = ref_bert.BertConfig(**SMALL)
    params = jax.tree_util.tree_map(np.asarray, ref_bert.bert_init(config, jax.random.PRNGKey(1)))
    encoder = port_bert.BertEncoder(port_bert.BertConfig(**SMALL), weights=port_bert.params_from_jax(params), **CPU)
    return params, jax.jit(functools.partial(ref_bert.bert_apply, config=config)), encoder


def _ref_forward(fwd):
    return lambda m, b: fwd(m, b["input_ids"], b["attention_mask"])[-1]


def _port_forward(m, b):
    return m(b["input_ids"], b["attention_mask"])[-1]


def _assert_scores(got, want, atol=SCORE_ATOL):
    assert sorted(got) == sorted(want)
    for k in KEYS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


def test_bert_init_matches_jax_within_ulps():
    """The default weights are jax.random.normal draws under
    PRNGKey(0); see INIT_ULPS."""
    want = port_bert.params_from_jax(jax.tree_util.tree_map(np.asarray, ref_bert.bert_init(ref_bert.BertConfig())))
    got = port_bert.bert_init(port_bert.BertConfig(), **CPU)
    assert sorted(got) == sorted(want)
    exact = total = 0
    for k, w in want.items():
        g = got[k].numpy()
        ulps = np.abs(g.view(np.int32).astype(np.int64) - w.numpy().view(np.int32).astype(np.int64))
        assert ulps.max() <= INIT_ULPS, (k, ulps.max())
        exact, total = exact + int((ulps == 0).sum()), total + ulps.size
    assert exact / total > 0.9


def test_params_from_jax_fills_every_key(small):
    params, _, encoder = small
    assert sorted(port_bert.params_from_jax(params)) == sorted(encoder.state_dict())


def test_hidden_states_match_reference(small):
    params, fwd, encoder = small
    rng = np.random.RandomState(0)
    ids = rng.randint(1000, SMALL["vocab_size"], (5, MAX_LEN)).astype(np.int32)
    mask = np.ones((5, MAX_LEN), np.int32)
    mask[2, 9:] = 0
    mask[4, 3:] = 0
    want = fwd(params, jnp.asarray(ids), jnp.asarray(mask))
    got = encoder(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(got) == len(want) == SMALL["num_hidden_layers"] + 1
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=HIDDEN_RTOL * np.abs(w).max(), rtol=0, err_msg=f"layer {i}")


def test_load_torch_bert_weights_takes_both_key_layouts(small):
    _, _, encoder = small
    sd = encoder.state_dict()
    prefixed = {f"bert.{k}": v + 1 for k, v in sd.items()}
    prefixed["bert.pooler.dense.weight"] = torch.zeros(3)  # ignored, as the JAX converter ignores it
    other = port_bert.BertEncoder(port_bert.BertConfig(**SMALL), weights=prefixed, **CPU)
    assert all(torch.equal(other.state_dict()[k], v + 1) for k, v in sd.items())
    port_bert.load_torch_bert_weights(other, sd)
    assert all(torch.equal(other.state_dict()[k], v) for k, v in sd.items())
    missing = {k: v for k, v in sd.items() if "layer.1." not in k}
    with pytest.raises(RuntimeError, match="Missing key"):
        port_bert.load_torch_bert_weights(other, missing)


def test_config_from_params_matches_reference(small):
    params, _, encoder = small
    want = ref_bert.config_from_params(jax.tree_util.tree_map(jnp.asarray, params))
    got = port_bert.config_from_params({f"bert.{k}": v for k, v in encoder.state_dict().items()})
    assert vars(got) == vars(want)


def test_full_float32_guards_the_encoder(small, monkeypatch):
    """The encoder's products run inside ``full_float32``, which
    restores the caller's TF32 flags."""
    _, _, encoder = small
    entered = []
    real = port_bert.full_float32

    def spy():
        entered.append(True)
        return real()

    monkeypatch.setattr(port_bert, "full_float32", spy)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        encoder(torch.tensor([[101, 1500, 102]]), torch.ones(1, 3, dtype=torch.int32))
        assert entered and torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        with full_float32():
            assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# BERTScore
# ---------------------------------------------------------------------------


def test_own_model_scores_match_reference(small):
    params, fwd, encoder = small
    want = ref_bs.bert_score(PREDS, REFS, model=params, user_forward_fn=_ref_forward(fwd), max_length=MAX_LEN,
                             **REF_TOK)
    got = port_bs.bert_score(PREDS, REFS, model=encoder, user_forward_fn=_port_forward, max_length=MAX_LEN,
                             **PORT_TOK, **CPU)
    _assert_scores(got, want)
    assert got["f1"][1] == pytest.approx(1.0, abs=SCORE_ATOL) and got["f1"][4] == pytest.approx(1.0, abs=SCORE_ATOL)


@pytest.mark.parametrize("case", [{}, {"idf": True, "return_hash": True}])
def test_default_encoder_scores_match_reference(case):
    want = ref_bs.bert_score(PREDS, REFS, max_length=MAX_LEN, **case)
    got = port_bs.bert_score(PREDS, REFS, max_length=MAX_LEN, **CPU, **case)
    _assert_scores(got, want)
    assert got.get("hash") == want.get("hash")


def test_swapping_sides_swaps_precision_and_recall(small):
    _, _, encoder = small
    kw = dict(model=encoder, user_forward_fn=_port_forward, max_length=MAX_LEN, **PORT_TOK, **CPU)
    a, b = port_bs.bert_score(PREDS, REFS, **kw), port_bs.bert_score(REFS, PREDS, **kw)
    np.testing.assert_allclose(a["precision"], b["recall"], atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(a["recall"], b["precision"], atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("source", ["array", "csv", "url"])
def test_baseline_rescaling_matches_reference(source):
    rng = np.random.RandomState(3)
    arr = (rng.rand(5, 3) * 0.5 + 0.3).astype(np.float32)
    kw = dict(max_length=MAX_LEN, rescale_with_baseline=True)
    if source == "array":
        ref_kw, port_kw = dict(baseline=jnp.asarray(arr)), dict(baseline=arr)
    elif source == "url":
        ref_kw = dict(baseline_url=f"file://{ref_bs.bundled_baseline_path()}")
        port_kw = dict(baseline_url=f"file://{port_bs.bundled_baseline_path()}")
    else:
        ref_kw, port_kw = dict(baseline_path=ref_bs.bundled_baseline_path()), dict(baseline_path=port_bs.bundled_baseline_path())
    _assert_scores(port_bs.bert_score(PREDS, REFS, **kw, **port_kw, **CPU), ref_bs.bert_score(PREDS, REFS, **kw, **ref_kw))


def test_bundled_baseline_is_the_reference_file():
    with open(port_bs.bundled_baseline_path(), "rb") as a, open(ref_bs.bundled_baseline_path(), "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(port_bs._read_baseline_csv(port_bs.bundled_baseline_path()).numpy(),
                                  np.asarray(ref_bs._read_baseline_csv(ref_bs.bundled_baseline_path())))
    with pytest.raises(FileNotFoundError):
        port_bs.bundled_baseline_path("no_such_baseline")


def test_failed_baseline_fetch_degrades_to_a_warning():
    with pytest.warns(UserWarning, match="Baseline"):
        out = port_bs.bert_score(["hi there"], ["hi there"], max_length=MAX_LEN, rescale_with_baseline=True,
                                 baseline_url="file:///nonexistent/baseline.tsv", **CPU)
    assert np.isfinite(out["f1"]).all()


def test_empty_and_mismatched_inputs_match_reference():
    for fn in (ref_bs.bert_score, functools.partial(port_bs.bert_score, **CPU)):
        with pytest.warns(UserWarning, match="empty"):
            out = fn([], [], return_hash=True)
        assert out == {"precision": [0.0], "recall": [0.0], "f1": [0.0], "hash": "None_LNone_no-idf"}
        with pytest.raises(ValueError, match="Number of predicted and reference sentences must be the same"):
            fn(["a"], ["a", "b"])


def test_wrong_model_output_shape_raises_as_reference():
    with pytest.raises(ValueError, match=r"\[batch_size, seq_len, model_dim\]"):
        ref_bs.bert_score(["a b"], ["a"], model=lambda **b: jnp.zeros((1, 4)), max_length=8)
    with pytest.raises(ValueError, match=r"\[batch_size, seq_len, model_dim\] i.e. \[1, 8, model_dim\]"):
        port_bs.bert_score(["a b"], ["a"], model=lambda **b: torch.zeros(1, 4), max_length=8, **CPU)


WORDS = {"up": 1.0, "down": -1.0, "flat": 0.5}
DIM = 4


def _word_tokenizer(sentences, max_length):
    """Word vectors as "ids" (one direction, signed), [CLS]/[SEP] framing."""
    ids = np.zeros((len(sentences), max_length, DIM), np.float32)
    mask = np.zeros((len(sentences), max_length), np.int32)
    for row, s in enumerate(sentences):
        words = s.split()[: max_length - 2]
        for col, w in enumerate(words, start=1):
            ids[row, col] = WORDS[w]
        mask[row, : len(words) + 2] = 1
    return {"input_ids": ids, "attention_mask": mask}


def test_all_negative_cosines_match_reference():
    """Every sentence pads to max_length with zero vectors, and the
    zeros (padding, [CLS], [SEP]) enter each greedy max: a sentence whose
    cosines are all negative scores 0, in both packages."""
    preds, refs = ["up up up", "up flat", "down"], ["down down", "flat up", "up up"]
    want = ref_bs.bert_score(preds, refs, model=lambda input_ids, attention_mask: input_ids,
                             user_tokenizer=_word_tokenizer, max_length=8)
    got = port_bs.bert_score(preds, refs, model=lambda input_ids, attention_mask: input_ids,
                             user_tokenizer=_word_tokenizer, max_length=8, **CPU)
    _assert_scores(got, want)
    assert got["precision"][0] == got["recall"][0] == got["f1"][0] == 0.0
    assert got["precision"][2] == 0.0


def test_named_model_path_matches_reference(tmp_path):
    """``model_name_or_path``: a tiny random HF ``BertModel`` and a
    ``BertTokenizer`` over a written vocabulary, saved to disk and loaded by
    both packages."""
    transformers = pytest.importorskip("transformers")
    config = transformers.BertConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                     intermediate_size=64, max_position_embeddings=32)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        transformers.BertModel(config).save_pretrained(tmp_path)
    words = sorted({w for s in PREDS + REFS for w in s.split()})
    (tmp_path / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    transformers.BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(tmp_path)
    # a tsv baseline for the three hidden states, read with all_layers
    baseline = tmp_path / "baseline.tsv"
    baseline.write_text("LAYER\tP\tR\tF\n0\t0.5\t0.52\t0.51\n1\t0.6\t0.61\t0.605\n2\t0.7\t0.72\t0.71\n")
    wants = []
    for kw in ({}, {"num_layers": 1, "idf": True}, {"all_layers": True},
               {"all_layers": True, "rescale_with_baseline": True, "baseline_path": str(baseline)}):
        wants.append(ref_bs.bert_score(PREDS, REFS, model_name_or_path=str(tmp_path), max_length=MAX_LEN, **kw))
        got = port_bs.bert_score(PREDS, REFS, model_name_or_path=str(tmp_path), max_length=MAX_LEN, **kw, **CPU)
        _assert_scores(got, wants[-1])
        if kw.get("all_layers"):
            assert np.asarray(got["f1"]).shape == (3, len(PREDS))
    with pytest.raises(ValueError, match="num_layers=3 is forbidden"):
        port_bs.bert_score(PREDS, REFS, model_name_or_path=str(tmp_path), num_layers=3, max_length=MAX_LEN, **CPU)
    m = port.BERTScore(model_name_or_path=str(tmp_path), max_length=MAX_LEN, **CPU)
    m.update(PREDS, REFS)
    assert m.preds_input_ids[0].dtype == torch.int32
    _assert_scores(m.compute(), wants[0])


def test_simple_tokenizer_matches_reference():
    want = ref_bs.SimpleTokenizer(max_length=MAX_LEN)(PREDS)
    got = port_bs.SimpleTokenizer(max_length=MAX_LEN)(PREDS)
    for k in ("input_ids", "attention_mask"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_module_matches_reference_and_holds_token_states_only(small):
    params, fwd, encoder = small
    jm = ref.BERTScore(model=params, user_forward_fn=_ref_forward(fwd), max_length=MAX_LEN, idf=True, **REF_TOK)
    pm = port.BERTScore(model=encoder, user_forward_fn=_port_forward, max_length=MAX_LEN, idf=True, **PORT_TOK, **CPU)
    for sl in (slice(0, 2), slice(2, 5)):
        _assert_scores(pm(PREDS[sl], REFS[sl]), jm(PREDS[sl], REFS[sl]))
    for name in ("preds_input_ids", "preds_attention_mask", "target_input_ids", "target_attention_mask"):
        state = getattr(pm, name)
        assert [tuple(s.shape) for s in state] == [(2, MAX_LEN), (3, MAX_LEN)]
        assert all(s.dtype == torch.int32 for s in state)
        np.testing.assert_array_equal(torch.cat(state).numpy(), np.concatenate([np.asarray(x) for x in getattr(jm, name)]))
    _assert_scores(pm.compute(), jm.compute())
    pm.persistent(True)
    assert sorted(pm.state_dict()) == sorted(["preds_input_ids", "preds_attention_mask", "target_input_ids",
                                              "target_attention_mask"])
    assert pm.model is encoder and not list(pm.children())
