"""BERTScore with a user-defined model and tokenizer, in PyTorch: the
counterpart of ``examples/bert_score-own_model.py``.

A custom tokenizer emits word *embeddings* as ``input_ids``, and a small
self-attention encoder (an ``nn.Module``) embeds them; both plug into
:class:`metrics_tpu_torch.BERTScore` through ``user_tokenizer`` and
``user_forward_fn``. The encoder's weights are the JAX example's:
``ops/prng.py`` draws them as ``jax.random`` does under ``PRNGKey(42)``
(a float32 normal within 4 ulps of JAX's).

    python examples/torch_bert_score_own_model.py               # on the card
    python examples/torch_bert_score_own_model.py --device cpu  # on the host
"""
import argparse
import math
import sys
from pathlib import Path
from pprint import pprint
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from metrics_tpu_torch import BERTScore  # noqa: E402
from metrics_tpu_torch.ops import prng  # noqa: E402
from metrics_tpu_torch.utils.device import resolve_device  # noqa: E402

_NUM_LAYERS = 2
_MODEL_DIM = 4
_NHEAD = 2
_MAX_LEN = 6


class UserTokenizer:
    """Required when a non-default model is used: maps sentences to a dict of
    ``input_ids`` (here: word embeddings) and ``attention_mask`` arrays,
    framing each sentence with CLS/SEP equivalents and padding to max_len."""

    CLS_TOKEN = "<cls>"
    SEP_TOKEN = "<sep>"
    PAD_TOKEN = "<pad>"

    def __init__(self) -> None:
        self.word2vec = {
            "hello": 0.5 * np.ones((1, _MODEL_DIM), dtype=np.float32),
            "world": -0.5 * np.ones((1, _MODEL_DIM), dtype=np.float32),
            self.CLS_TOKEN: np.zeros((1, _MODEL_DIM), dtype=np.float32),
            self.SEP_TOKEN: np.zeros((1, _MODEL_DIM), dtype=np.float32),
            self.PAD_TOKEN: np.zeros((1, _MODEL_DIM), dtype=np.float32),
        }

    def __call__(self, sentences: Union[str, List[str]], max_len: int = _MAX_LEN) -> Dict[str, np.ndarray]:
        if isinstance(sentences, str):
            sentences = [sentences]
        sentences = [" ".join([self.CLS_TOKEN, s, self.SEP_TOKEN]) for s in sentences]
        tokenized = [
            s.lower().split()[:max_len] + [self.PAD_TOKEN] * (max_len - len(s.lower().split()))
            for s in sentences
        ]
        return {
            "input_ids": np.stack([np.concatenate([self.word2vec[w] for w in s]) for s in tokenized]),
            "attention_mask": np.stack(
                [[1 if w != self.PAD_TOKEN else 0 for w in s] for s in tokenized]
            ).astype(np.int32),
        }


class TinyEncoder(nn.Module):
    """A tiny deterministic transformer encoder: per layer, multi-head
    self-attention from one ``qkv`` projection with a residual, then
    ``x + relu(x @ ffn)``."""

    def __init__(self, num_layers: int = _NUM_LAYERS, d_model: int = _MODEL_DIM, nhead: int = _NHEAD,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__()
        self.nhead = nhead
        key = prng.prng_key(42, device=resolve_device(device))
        self.qkv, self.ffn = nn.ParameterList(), nn.ParameterList()
        for _ in range(num_layers):  # the JAX example's split order
            key, k1, k2 = prng.split(key, 3)
            self.qkv.append(nn.Parameter(prng.normal(k1, (d_model, 3 * d_model)) * 0.3, requires_grad=False))
            self.ffn.append(nn.Parameter(prng.normal(k2, (d_model, d_model)) * 0.3, requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        head_dim = d // self.nhead

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, s, self.nhead, head_dim).transpose(1, 2)

        for qkv, ffn in zip(self.qkv, self.ffn):
            q, k, v = (x @ qkv).split(d, dim=-1)
            attn = torch.softmax(heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(head_dim), dim=-1)
            x = x + (attn @ heads(v)).transpose(1, 2).reshape(b, s, d)
            x = x + torch.relu(x @ ffn)
        return x


def user_forward_fn(model: TinyEncoder, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(model, batch) -> [batch, seq_len, model_dim] embeddings."""
    return model(batch["input_ids"])


_PREDS = ["hello", "hello world", "world world world"]
_REFS = ["hello", "hello hello", "hello world hello"]


def run(device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
    """BERTScore of the example's pairs through the tiny encoder."""
    device = resolve_device(device)
    metric = BERTScore(
        model=TinyEncoder(device=device), user_tokenizer=UserTokenizer(), user_forward_fn=user_forward_fn,
        max_length=_MAX_LEN, device=device,
    )
    metric.update(_PREDS, _REFS)
    return metric.compute()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    result = run(parser.parse_args(argv).device)
    pprint(result)
    return result


if __name__ == "__main__":
    main()
