"""BERT encoder as an ``nn.Module``, in HuggingFace ``BertModel``'s key layout.

Counterpart of ``metrics_tpu/models/bert.py``: embeddings and N
post-layernorm transformer layers, returning **all** ``N + 1`` hidden
states (BERTScore selects one or uses all). The arithmetic is the JAX
package's: an additive attention mask of ``finfo(float32).min``, exact
(erf) GELU, biased layer norm with eps 1e-12, every product in true float32
(``utils/device.py::full_float32``: TF32 is off inside the forward whatever
the caller's flags).

Weights:

- :func:`load_torch_bert_weights` loads a HF ``BertModel`` state dict
  (``bert.``-prefixed or not; the pooler and other extra keys are ignored);
- :func:`params_from_jax` turns the JAX package's params pytree (numpy
  arrays) into this module's state dict;
- :func:`bert_init` draws the JAX package's default weights:
  ``jax.random.normal`` under ``PRNGKey(0)`` split ``3 + 6 * L`` ways
  (``ops/prng.py``), bit for bit but for the last bits of ``erfinv`` (within
  4 ulps).

Without weights the encoder is random: the BERTScore mechanism is exact,
but scores are not comparable with published numbers.
"""
import math
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.ops import prng
from metrics_tpu_torch.utils.device import full_float32, resolve_device


class BertConfig:
    """Minimal config mirroring HF ``BertConfig`` fields BERTScore needs
    (the JAX package's defaults: a small 4-layer encoder)."""

    def __init__(
        self,
        vocab_size: int = 30522,
        hidden_size: int = 128,
        num_hidden_layers: int = 4,
        num_attention_heads: int = 4,
        intermediate_size: int = 512,
        max_position_embeddings: int = 512,
        type_vocab_size: int = 2,
        layer_norm_eps: float = 1e-12,
    ) -> None:
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps


class _DenseNorm(nn.Module):
    """HF's ``BertSelfOutput`` / ``BertOutput``: dense, then a residual layer norm."""

    def __init__(self, din: int, dout: int, eps: float) -> None:
        super().__init__()
        self.dense = nn.Linear(din, dout)
        self.LayerNorm = nn.LayerNorm(dout, eps=eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dense(x))


class _SelfAttention(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.query, self.key, self.value = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)


class _Attention(nn.Module):
    def __init__(self, d: int, eps: float) -> None:
        super().__init__()
        self.self = _SelfAttention(d)
        self.output = _DenseNorm(d, d, eps)


class _Intermediate(nn.Module):
    def __init__(self, d: int, inter: int) -> None:
        super().__init__()
        self.dense = nn.Linear(d, inter)


class _Layer(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.num_heads = config.num_attention_heads
        self.attention = _Attention(d, eps)
        self.intermediate = _Intermediate(d, config.intermediate_size)
        self.output = _DenseNorm(config.intermediate_size, d, eps)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        batch, seq, d = x.shape
        head_dim = d // self.num_heads

        def heads(t: torch.Tensor) -> torch.Tensor:  # [B, S, D] -> [B, H, S, hd]
            return t.reshape(batch, seq, self.num_heads, head_dim).transpose(1, 2)

        sa = self.attention.self
        q, k, v = heads(sa.query(x)), heads(sa.key(x)), heads(sa.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim) + attn_bias
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        ctx = ctx.transpose(1, 2).reshape(batch, seq, d)
        x = self.attention.output(ctx, x)
        return self.output(F.gelu(self.intermediate.dense(x), approximate="none"), x)


class _Embeddings(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        d = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, d)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, d)
        self.LayerNorm = nn.LayerNorm(d, eps=config.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, config: BertConfig) -> None:
        super().__init__()
        self.layer = nn.ModuleList(_Layer(config) for _ in range(config.num_hidden_layers))


class BertEncoder(nn.Module):
    """BERT encoder returning every hidden state, ``num_hidden_layers + 1``
    tensors of ``[batch, seq, hidden]``.

    Args:
        config: the shape; the JAX package's default :class:`BertConfig`
            when ``None``.
        weights: a HF ``BertModel`` state dict (``bert.``-prefixed or not),
            loaded with :func:`load_torch_bert_weights`; the JAX package's
            default weights (:func:`bert_init`) otherwise.
        device: where the encoder lives; ``None`` means CUDA.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.models.bert import BertConfig, BertEncoder
        >>> enc = BertEncoder(BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
        ...                              num_attention_heads=2, intermediate_size=64), device="cpu")
        >>> hidden = enc(torch.tensor([[1, 7, 8, 2]]), torch.tensor([[1, 1, 1, 1]]))
        >>> len(hidden), tuple(hidden[-1].shape)
        (3, (1, 4, 32))
    """

    def __init__(
        self,
        config: Optional[BertConfig] = None,
        weights: Optional[Mapping[str, Any]] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        self.config = config = config or BertConfig()
        device = resolve_device(device)
        with torch.device("meta"):  # no default init: every weight is loaded below
            self.embeddings = _Embeddings(config)
            self.encoder = _Encoder(config)
        self.to_empty(device=device)
        if weights is not None:
            load_torch_bert_weights(self, weights)
        else:
            self.load_state_dict(bert_init(config, device=device))
        self.requires_grad_(False)
        self.eval()

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> List[torch.Tensor]:
        emb = self.embeddings
        seq_len = input_ids.shape[1]
        input_ids = input_ids.to(torch.int64)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        with full_float32():
            x = (
                emb.word_embeddings(input_ids)
                + emb.position_embeddings.weight[None, :seq_len]
                + emb.token_type_embeddings(token_type_ids.to(torch.int64))
            )
            x = emb.LayerNorm(x)
            # additive mask: 0 for real tokens, the dtype's lowest value for padding
            neg = torch.finfo(x.dtype).min
            attn_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg).to(x.dtype)
            hidden_states = [x]
            for layer in self.encoder.layer:
                x = layer(x, attn_bias)
                hidden_states.append(x)
        return hidden_states


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_DENSE = {
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "ffn_in": "intermediate.dense",
    "ffn_out": "output.dense",
}
_NORMS = {"attn_ln": "attention.output.LayerNorm", "ffn_ln": "output.LayerNorm"}


def _state_dict_from_tree(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's params layout (torch tensors) as this encoder's
    state dict: dense kernels ``[in, out]`` to ``Linear`` weights ``[out, in]``."""
    sd = {
        "embeddings.word_embeddings.weight": params["word_embeddings"],
        "embeddings.position_embeddings.weight": params["position_embeddings"],
        "embeddings.token_type_embeddings.weight": params["token_type_embeddings"],
        "embeddings.LayerNorm.weight": params["embeddings_ln"]["scale"],
        "embeddings.LayerNorm.bias": params["embeddings_ln"]["bias"],
    }
    for i, layer in enumerate(params["layers"]):
        base = f"encoder.layer.{i}"
        for key, name in _DENSE.items():
            sd[f"{base}.{name}.weight"] = layer[key]["kernel"].T.contiguous()
            sd[f"{base}.{name}.bias"] = layer[key]["bias"]
        for key, name in _NORMS.items():
            sd[f"{base}.{name}.weight"] = layer[key]["scale"]
            sd[f"{base}.{name}.bias"] = layer[key]["bias"]
    return sd


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's BERT params pytree (``bert_init`` or
    ``load_torch_bert_weights`` there; arrays or numpy) as a
    :class:`BertEncoder` state dict, float32 on the host."""

    def to_torch(tree: Any) -> Any:
        if isinstance(tree, Mapping):
            return {k: to_torch(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [to_torch(v) for v in tree]
        return torch.from_numpy(np.array(tree, dtype=np.float32))

    return _state_dict_from_tree(to_torch(params))


def bert_init(
    config: Optional[BertConfig] = None,
    key: Optional[torch.Tensor] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """The JAX package's ``bert_init(config, key)`` weights as a
    :class:`BertEncoder` state dict: normal draws times 0.02 from
    ``split(key, 3 + 6 * L)``, zero biases, unit layer-norm scales.
    ``key`` is a :func:`~metrics_tpu_torch.ops.prng.prng_key`; ``PRNGKey(0)``
    when ``None``. Drawn on ``device`` (``None`` means CUDA)."""
    config = config or BertConfig()
    device = resolve_device(device)
    key = prng.prng_key(0, device=device) if key is None else key.to(device)
    d, inter = config.hidden_size, config.intermediate_size
    keys = prng.split(key, 3 + 6 * config.num_hidden_layers)

    def normal(i: int, shape: tuple) -> torch.Tensor:
        return prng.normal(keys[i], shape) * 0.02

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(n, device=device)

    def ln() -> Dict[str, torch.Tensor]:
        return {"scale": torch.ones(d, device=device), "bias": zeros(d)}

    params: Dict[str, Any] = {
        "word_embeddings": normal(0, (config.vocab_size, d)),
        "position_embeddings": normal(1, (config.max_position_embeddings, d)),
        "token_type_embeddings": normal(2, (config.type_vocab_size, d)),
        "embeddings_ln": ln(),
        "layers": [],
    }
    shapes = {"q": (d, d), "k": (d, d), "v": (d, d), "attn_out": (d, d), "ffn_in": (d, inter), "ffn_out": (inter, d)}
    for i in range(config.num_hidden_layers):
        layer: Dict[str, Any] = {}
        for j, (name, shape) in enumerate(shapes.items()):
            layer[name] = {"kernel": normal(3 + 6 * i + j, shape), "bias": zeros(shape[1])}
        layer["attn_ln"], layer["ffn_ln"] = ln(), ln()
        params["layers"].append(layer)
    return _state_dict_from_tree(params)


def _strip_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    return {k[5:] if k.startswith("bert.") else k: v for k, v in state_dict.items()}


def load_torch_bert_weights(model: BertEncoder, source: Union[str, Mapping[str, Any]]) -> BertEncoder:
    """Load a HF ``BertModel`` state dict (or a ``.pt`` path to one) into
    ``model``: ``bert.``-prefixed or unprefixed keys; keys the encoder does
    not have (the pooler, ``position_ids``, a task head) are ignored, and a
    missing one raises."""
    if isinstance(source, str):
        source = torch.load(source, map_location="cpu")
    own = model.state_dict()
    sd = {k: torch.as_tensor(v) for k, v in _strip_prefix(source).items() if k in own}
    model.load_state_dict(sd, strict=True)
    return model


def config_from_params(state_dict: Mapping[str, Any]) -> BertConfig:
    """Infer a :class:`BertConfig` from a HF-layout state dict (heads as HF's
    BERTs have them: hidden / 64)."""
    sd = _strip_prefix(state_dict)
    vocab, d = sd["embeddings.word_embeddings.weight"].shape
    n_layers = 0
    while f"encoder.layer.{n_layers}.attention.self.query.weight" in sd:
        n_layers += 1
    inter = sd["encoder.layer.0.intermediate.dense.weight"].shape[0] if n_layers else 4 * d
    return BertConfig(
        vocab_size=vocab,
        hidden_size=d,
        num_hidden_layers=n_layers,
        num_attention_heads=max(1, d // 64),
        intermediate_size=inter,
        max_position_embeddings=sd["embeddings.position_embeddings.weight"].shape[0],
        type_vocab_size=sd["embeddings.token_type_embeddings.weight"].shape[0],
    )
