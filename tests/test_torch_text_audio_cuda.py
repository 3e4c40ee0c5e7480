"""The text and audio families' cases that need the card. They import
nothing of JAX, so that they run on a machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_text_audio_cuda.py

Without a card each skips inside the test.

Tolerances: BERTScore on the card against the port on the CPU within
``SCORE_ATOL = 1e-5`` (two 2-layer encoders of width 64, float32 sums of at
most 128 products in another order, then cosines of unit vectors); PIT's
values within ``DB_ATOL = 1e-5`` dB (float32 sums over 256 samples in
another order, 10 log10 of their ratio). String metrics hold integer
counters and per-sentence values made on the host: equal.
"""
import numpy as np
import pytest
import torch

import metrics_tpu_torch as port
from metrics_tpu_torch.functional.audio import pit, si_sdr
from metrics_tpu_torch.models.bert import BertConfig, BertEncoder

SCORE_ATOL, DB_ATOL = 1e-5, 1e-5
SMALL = dict(vocab_size=30522, hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128)
PREDS = ["the quick brown fox jumps. it ran!", "hello there", "a b c d e f g", "same words"]
REFS = ["a quick brown dog jumped. it sat.", "hello there", "a b c", "same words"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _last_hidden(model, batch):
    return model(batch["input_ids"], batch["attention_mask"])[-1]


@pytest.mark.cuda
def test_bertscore_on_the_card_matches_the_cpu_whatever_the_tf32_flags():
    device = _card()
    cpu_enc = BertEncoder(BertConfig(**SMALL), device="cpu")
    card_enc = BertEncoder(BertConfig(**SMALL), weights=cpu_enc.state_dict(), device=device)
    want = port.BERTScore(model=cpu_enc, user_forward_fn=_last_hidden, max_length=16, idf=True, device="cpu")
    want.update(PREDS, REFS)
    want = want.compute()
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((False, False), (True, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            m = port.BERTScore(model=card_enc, user_forward_fn=_last_hidden, max_length=16, idf=True)
            m.update(PREDS, REFS)
            assert m.preds_input_ids[0].device.type == "cuda" and m.preds_input_ids[0].dtype == torch.int32
            got = m.compute()
            for k in ("precision", "recall", "f1"):
                np.testing.assert_allclose(got[k], want[k], atol=SCORE_ATOL, rtol=0, err_msg=f"{k} {flags}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
def test_encoder_follows_the_metric_and_stays_out_of_its_state():
    _card()
    enc = BertEncoder(BertConfig(**SMALL), device="cpu")
    m = port.BERTScore(model=enc, user_forward_fn=_last_hidden, max_length=16)
    assert next(enc.parameters()).device.type == "cuda"
    m.cpu()
    assert next(enc.parameters()).device.type == "cpu"
    m.persistent(True)
    assert all(not k.startswith("model") for k in m.state_dict())


@pytest.mark.cuda
def test_string_metrics_on_the_card_equal_the_cpu():
    _card()
    for make in (lambda **kw: port.WER(**kw), lambda **kw: port.ROUGEScore(use_stemmer=True, **kw)):
        card, cpu = make(), make(device="cpu")
        for a, b in ((PREDS[:2], REFS[:2]), (PREDS[2:], REFS[2:])):
            card.update(a, b)
            cpu.update(a, b)
        for k, v in card._state.items():
            w = cpu._state[k]
            if isinstance(v, list):
                assert all(x.device.type == "cuda" for x in v) and torch.equal(torch.cat(v).cpu(), torch.cat(w))
            else:
                assert v.device.type == "cuda" and torch.equal(v.cpu(), w)
    bleu_card, bleu_cpu = port.BLEUScore(), port.BLEUScore(device="cpu")
    refs, hyps = [[r.split()] for r in REFS], [p.split() for p in PREDS]
    bleu_card.update(refs, hyps)
    bleu_cpu.update(refs, hyps)
    assert torch.equal(bleu_card.numerator.cpu(), bleu_cpu.numerator)


@pytest.mark.cuda
@pytest.mark.parametrize("spk", [2, 3, 7])
def test_pit_on_the_card_matches_the_cpu(spk):
    device = _card()
    rng = np.random.RandomState(spk)
    target = torch.from_numpy(rng.randn(4, spk, 256).astype(np.float32))
    preds = target[:, torch.from_numpy(rng.permutation(spk))] + 0.5 * torch.from_numpy(
        rng.randn(4, spk, 256).astype(np.float32))
    want_metric, want_perm = pit(preds, target, si_sdr)
    got_metric, got_perm = pit(preds.to(device), target.to(device), si_sdr)
    assert got_perm.device.type == "cuda"
    np.testing.assert_allclose(got_metric.cpu().numpy(), want_metric.numpy(), atol=DB_ATOL, rtol=0)
    assert torch.equal(got_perm.cpu(), want_perm)
