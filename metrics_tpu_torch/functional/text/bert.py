"""BERTScore — functional layer.

Counterpart of ``metrics_tpu/functional/text/bert.py``:

- **Fixed padding.** Every sentence pads to ``max_length``, as in the JAX
  package; padded positions embed as zero vectors, and a zero therefore
  enters every greedy max. (The torchmetrics reference trims each batch to
  its longest sentence, which scores a sentence whose cosines are all
  negative differently.) The corpus embeds in chunks of ``batch_size``.
- **Host and device.** Tokenizing, the IDF table and the per-token weights
  run on the host in numpy, as the JAX package's; the encoder, the
  ``blpd,blrd->blpr`` cosine similarity, the greedy max-matching and the
  weighting run on ``device`` (the card unless the caller asks for the
  CPU), in true float32 (``utils/device.py::full_float32``), whatever the
  caller's TF32 flags.
- **Models.** With no model, the in-package :class:`BertEncoder` with the
  JAX package's default weights (``bert_init``); ``model_name_or_path``
  loads a HF checkpoint through ``transformers`` (imported only there) into
  the same encoder; ``model=`` with ``user_forward_fn`` runs any callable.
- **Baselines** come from an array, a local csv/tsv (``baseline_path``) or a
  URL (``baseline_url``, or the official bert-score tree for a named
  model); a failed fetch degrades to a warning.
"""
import csv
import math
import os
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.models.bert import BertConfig, BertEncoder, config_from_params
from metrics_tpu_torch.utils.device import full_float32, resolve_device
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE
from metrics_tpu_torch.utils.prints import rank_zero_warn

_CLS_ID, _SEP_ID, _PAD_ID = 101, 102, 0

# (tokenizer, forward) per (model key, num_layers, all_layers, device)
_FORWARD_CACHE: Dict[Tuple, Tuple[Any, Callable]] = {}


class SimpleTokenizer:
    """Deterministic hash tokenizer used when no tokenizer is supplied.

    Lowercased word-ish tokens hashed into the vocab range, [CLS]/[SEP]
    framing and zero padding: the JAX package's ids, shape-compatible with a
    BERT tokenizer, without the ``transformers`` package.
    """

    def __init__(self, vocab_size: int = 30522, max_length: int = 512) -> None:
        self.vocab_size = vocab_size
        self.max_length = max_length

    def __call__(self, text: List[str], max_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        import re
        import zlib

        max_length = max_length or self.max_length
        ids = np.full((len(text), max_length), _PAD_ID, dtype=np.int32)
        mask = np.zeros((len(text), max_length), dtype=np.int32)
        for row, sentence in enumerate(text):
            tokens = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", sentence.lower())
            tokens = tokens[: max_length - 2]
            ids[row, 0] = _CLS_ID
            for col, tok in enumerate(tokens, start=1):
                # crc32: stable across processes and ranks (builtin hash() is
                # salted per process)
                ids[row, col] = 1000 + zlib.crc32(tok.encode()) % (self.vocab_size - 1000)
            ids[row, len(tokens) + 1] = _SEP_ID
            mask[row, : len(tokens) + 2] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _preprocess_text(
    text: List[str], tokenizer: Any, max_length: int = 512, own_tokenizer: bool = False
) -> Dict[str, np.ndarray]:
    """Tokenize to fixed ``[N, max_length]`` host arrays (no length sorting)."""
    if not own_tokenizer:
        out = tokenizer(text, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
    else:
        try:
            out = tokenizer(text, max_length)
        except BaseException as e:  # noqa: B036 - the JAX package's contract
            raise BaseException(f"Tokenization was not successful: {e}")
    return {"input_ids": np.asarray(out["input_ids"]), "attention_mask": np.asarray(out["attention_mask"])}


def _special_token_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Zero out [CLS] (position 0) and [SEP] (last attended position), by
    elementwise ops (an indexed store of a host scalar would read the host
    on the card)."""
    sep_pos = torch.argmax(torch.cumsum(attention_mask, dim=-1) - 0.1, dim=-1)
    pos = torch.arange(attention_mask.shape[-1], device=attention_mask.device)
    keep = (pos[None, :] != 0) & (pos[None, :] != sep_pos[:, None])
    return attention_mask * keep


def _tokens_idf(input_ids: np.ndarray, attention_mask: np.ndarray) -> Dict[int, float]:
    """Inverse document frequencies over the reference corpus (host)."""
    num_sentences = input_ids.shape[0]
    counter: Counter = Counter()
    for row in range(num_sentences):
        counter.update(set(input_ids[row][attention_mask[row] > 0].tolist()))
    default = math.log((num_sentences + 1) / 1)
    idf = {idx: math.log((num_sentences + 1) / (occ + 1)) for idx, occ in counter.items()}

    class _IdfTable(dict):
        def __missing__(self, key: int) -> float:
            return default

    return _IdfTable(idf)


def _idf_matrix(input_ids: np.ndarray, idf_table: Dict[int, float]) -> np.ndarray:
    lookup = np.vectorize(lambda t: idf_table[int(t)])
    return lookup(input_ids).astype(np.float32)


def _normalize_and_mask(out: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """``[B, L, S, D]`` unit vectors (zero vectors stay zero, not NaN), with
    [CLS], [SEP] and padding zeroed."""
    norm = torch.linalg.norm(out, dim=-1, keepdim=True)
    out = out / torch.where(norm > 0, norm, 1.0)
    return out * _special_token_mask(attention_mask)[:, None, :, None].to(out.dtype)


def _embed_corpus(
    forward: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    batch_size: int,
) -> torch.Tensor:
    """Run the forward in chunks of ``batch_size`` sentences; ``[N, L, S, D]``,
    each chunk written into one preallocated tensor (a concatenation would
    hold the corpus's embeddings twice)."""
    n = input_ids.shape[0]
    out = None
    for start in range(0, n, batch_size):
        chunk = forward(input_ids[start : start + batch_size], attention_mask[start : start + batch_size])
        if out is None:
            out = chunk.new_empty((n,) + tuple(chunk.shape[1:]))
        out[start : start + chunk.shape[0]] = chunk
    return out


def _score_from_embeddings(
    pred_emb: torch.Tensor,
    ref_emb: torch.Tensor,
    pred_idf_scale: torch.Tensor,
    ref_idf_scale: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy-match precision, recall and F1, ``[L, N]`` (``[N]`` for one
    layer), in true float32."""
    with full_float32():
        cos_sim = torch.matmul(pred_emb, ref_emb.transpose(-1, -2))  # blpd,blrd->blpr
        precision = torch.einsum("bls,bs->bl", cos_sim.max(dim=3).values, pred_idf_scale)
        recall = torch.einsum("bls,bs->bl", cos_sim.max(dim=2).values, ref_idf_scale)
    denom = precision + recall
    f1 = torch.where(denom > 0, 2 * precision * recall / torch.where(denom == 0, 1.0, denom), 0.0)

    def to_layer_major(t: torch.Tensor) -> torch.Tensor:
        # [B, L] -> [L, B]; drop only the layer axis when single-layer so a
        # one-sentence batch still yields a per-sentence list
        t = t.transpose(0, 1)
        return t[0] if t.shape[0] == 1 else t

    return to_layer_major(precision), to_layer_major(recall), to_layer_major(f1)


def bundled_baseline_path(name: str = "example_en") -> str:
    """Path to a baseline csv shipped with the package.

    Only ``example_en`` ships: a synthetic five-representation baseline
    matching the default :class:`BertConfig`, for tests and as a format
    template. Real baselines are the official bert-score repository's
    ``rescale_baseline/<lang>/<model>.tsv``: fetch one on a connected
    machine and point ``baseline_path`` at it.
    """
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "text", "baselines",
                        f"{name}.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no bundled baseline named {name!r} (looked at {path})")
    return path


def _baseline_rows(lines: Any, delimiter: str) -> torch.Tensor:
    rows = [[float(item) for item in row] for idx, row in enumerate(csv.reader(lines, delimiter=delimiter)) if idx > 0]
    return torch.tensor(rows, dtype=torch.float32)[:, 1:]


def _read_baseline_csv(path: str) -> torch.Tensor:
    with open(path) as handle:
        return _baseline_rows(handle, "\t" if path.endswith(".tsv") else ",")


# the official bert-score baseline tree
_BASELINE_URL_BASE = "https://raw.githubusercontent.com/Tiiiger/bert_score/master/bert_score/rescale_baseline"


def _read_baseline_url(url: str, timeout: float = 30.0) -> torch.Tensor:
    """Fetch a baseline csv/tsv by URL (``file://`` included). Needs network
    access for a remote URL: offline runs pass ``baseline_path``."""
    import io
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as response:  # noqa: S310 - a user-supplied source
        text = response.read().decode("utf-8")
    return _baseline_rows(io.StringIO(text), "\t" if url.endswith(".tsv") else ",")


def _rescale_with_baseline(
    precision: torch.Tensor,
    recall: torch.Tensor,
    f1: torch.Tensor,
    baseline: torch.Tensor,
    num_layers: Optional[int],
    all_layers: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if num_layers is None and not all_layers:
        num_layers = -1
    metrics = torch.stack([precision, recall, f1], dim=-1)
    scale = baseline[:, None, :] if all_layers else baseline[num_layers]
    metrics = (metrics - scale) / (1 - scale)
    return metrics[..., 0], metrics[..., 1], metrics[..., 2]


def _get_hash(model_name_or_path: Optional[str], num_layers: Optional[int], idf: bool) -> str:
    return f"{model_name_or_path}_L{num_layers}{'_idf' if idf else '_no-idf'}"


def _default_model_forward(
    encoder: BertEncoder, num_layers: Optional[int], all_layers: bool
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The in-package encoder's forward returning ``[B, L, S, D]`` unit vectors."""

    def fwd(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        hidden = encoder(input_ids, attention_mask)
        if all_layers:
            out = torch.stack(hidden, dim=1)
        else:
            out = hidden[num_layers if num_layers is not None else -1][:, None]
        return _normalize_and_mask(out, attention_mask)

    return fwd


def _user_model_forward(model: Any, user_forward_fn: Optional[Callable]) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Wrap a user model or callable into the ``[B, L, S, D]`` unit-vector contract."""

    def fwd(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        batch = {"input_ids": input_ids, "attention_mask": attention_mask}
        out = user_forward_fn(model, batch) if user_forward_fn else model(**batch)
        out = torch.as_tensor(out, device=input_ids.device)
        if out.ndim != 3 or out.shape[0] != input_ids.shape[0] or out.shape[1] != input_ids.shape[1]:
            raise ValueError(
                "The model output must be a tensor of shape [batch_size, seq_len, model_dim] "
                f"i.e. [{input_ids.shape[0]}, {input_ids.shape[1]}, model_dim], but got {tuple(out.shape)}."
            )
        return _normalize_and_mask(out[:, None], attention_mask)

    return fwd


def _as_float32_tensor(x: Any) -> torch.Tensor:
    return torch.as_tensor(x.cpu() if isinstance(x, torch.Tensor) else np.asarray(x), dtype=torch.float32)


def bert_score(
    predictions: Union[List[str], Dict[str, Any]],
    references: Union[List[str], Dict[str, Any]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Any = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 4,  # the reference's default; inert (no host DataLoader pool)
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
    baseline: Optional[Any] = None,
) -> Dict[str, Union[List[float], str]]:
    """BERTScore: greedy cosine matching of contextual embeddings.

    Args:
        predictions: candidate sentences, or a dict of ``input_ids`` /
            ``attention_mask`` arrays or tensors (already tokenized).
        references: reference sentences or tokenized dict.
        model_name_or_path: HF model name or directory, loaded through
            ``transformers`` (needs the package and a local checkpoint) into
            :class:`~metrics_tpu_torch.models.bert.BertEncoder`.
        num_layers: hidden-state index to use (default: last).
        all_layers: score with every layer's representation.
        model: user model, called as ``user_forward_fn(model, batch)`` or
            ``model(**batch)``; it gets ``batch`` tensors on ``device``.
        user_tokenizer: callable ``(List[str], max_length) -> dict`` of arrays.
        user_forward_fn: ``(model, batch_dict) -> [B, S, D]`` embeddings.
        idf: weight tokens by inverse document frequency over the references.
        device: where the encoder and the scoring run; ``None`` means CUDA.
        max_length: pad/truncate length.
        batch_size: chunk size for the embedding forward.
        rescale_with_baseline: linearly rescale with a per-layer baseline.
        baseline_path: local csv/tsv with baseline values.
        baseline_url: fetch the baseline csv/tsv by URL; when neither path
            nor url is given and a ``model_name_or_path`` is set, the
            official bert-score tree is tried (``<base>/<lang>/<model>.tsv``).
        baseline: explicit baseline array ``[n_layers(+1), 3]``.

    Returns:
        dict with per-sentence ``precision``/``recall``/``f1`` lists
        (+ ``hash`` when ``return_hash``).

    Example (a toy embedding table in place of an encoder):
        >>> import torch
        >>> table = torch.randn(30522, 8, generator=torch.Generator().manual_seed(0))
        >>> def embed(input_ids, attention_mask):
        ...     return table[input_ids.long()]
        >>> predictions = ["hello there", "general kenobi"]
        >>> references = ["hello there", "master kenobi"]
        >>> score = bert_score(predictions, references, model=embed, max_length=16, device="cpu")
        >>> sorted(score.keys()), round(score["f1"][0], 4)
        (['f1', 'precision', 'recall'], 1.0)
    """
    if len(predictions) != len(references):
        raise ValueError("Number of predicted and reference sentences must be the same!")

    _are_empty_lists = all(isinstance(text, list) and len(text) == 0 for text in (predictions, references))
    if _are_empty_lists:
        rank_zero_warn("Predictions and references are empty.")
        output_dict: Dict[str, Union[List[float], str]] = {"precision": [0.0], "recall": [0.0], "f1": [0.0]}
        if return_hash:
            output_dict["hash"] = _get_hash(model_name_or_path, num_layers, idf)
        return output_dict

    device = resolve_device(device)
    # ---- resolve tokenizer + forward ------------------------------------
    # named and default models cache (tokenizer, forward): BERTScore.compute
    # every step reuses one encoder instead of reloading it
    if model is not None:
        tokenizer = user_tokenizer or SimpleTokenizer(max_length=max_length)
        forward = _user_model_forward(model, user_forward_fn)
        own_tokenizer = True
    elif model_name_or_path is not None:
        if not _TRANSFORMERS_AVAILABLE:
            raise ValueError(
                "`bert_score` with a named pretrained model requires the `transformers` "
                "package. Pass `model`/`user_forward_fn` for a self-contained model instead."
            )
        cache_key = (model_name_or_path, num_layers, all_layers, str(device))
        cached = _FORWARD_CACHE.get(cache_key)
        if cached is None:
            from transformers import AutoModel, AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
            hf_model = AutoModel.from_pretrained(model_name_or_path)
            state_dict = hf_model.state_dict()
            config = config_from_params(state_dict)
            if getattr(hf_model.config, "num_attention_heads", None):
                config.num_attention_heads = hf_model.config.num_attention_heads
            if num_layers is not None and num_layers > config.num_hidden_layers:
                raise ValueError(
                    f"num_layers={num_layers} is forbidden for {model_name_or_path}. "
                    f"Please use num_layers <= {config.num_hidden_layers}"
                )
            encoder = BertEncoder(config, weights=state_dict, device=device)
            forward = _default_model_forward(encoder, num_layers, all_layers)
            _FORWARD_CACHE[cache_key] = (tokenizer, forward)
        else:
            tokenizer, forward = cached
        own_tokenizer = False
    else:
        rank_zero_warn(
            "No model specified — using the in-package BERT encoder with deterministic "
            "random weights. The BERTScore mechanism is exact but scores are not comparable "
            "with pretrained-model numbers; pass `model_name_or_path` or `model`."
        )
        config = BertConfig()
        cache_key = ("__default__", num_layers, all_layers, str(device))
        cached = _FORWARD_CACHE.get(cache_key)
        if cached is None:
            forward = _default_model_forward(BertEncoder(config, device=device), num_layers, all_layers)
            _FORWARD_CACHE[cache_key] = (None, forward)
        else:
            forward = cached[1]
        tokenizer = user_tokenizer or SimpleTokenizer(config.vocab_size, max_length)
        own_tokenizer = True

    # ---- tokenize (host) -------------------------------------------------
    _are_valid_tensors = all(isinstance(text, dict) and "input_ids" in text for text in (predictions, references))
    if _are_valid_tensors:
        pred_tok, ref_tok = predictions, references
    else:
        pred_tok = _preprocess_text(list(predictions), tokenizer, max_length, own_tokenizer)
        ref_tok = _preprocess_text(list(references), tokenizer, max_length, own_tokenizer)

    def on_host(x: Any) -> np.ndarray:
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def on_device(x: Any) -> torch.Tensor:
        return torch.as_tensor(x, device=device)

    # ---- IDF weighting (host table, host weights) -------------------------
    pred_mask, ref_mask = on_host(pred_tok["attention_mask"]), on_host(ref_tok["attention_mask"])
    pred_special = _special_token_mask(torch.from_numpy(pred_mask)).numpy().astype(np.float32)
    ref_special = _special_token_mask(torch.from_numpy(ref_mask)).numpy().astype(np.float32)
    if idf:
        idf_table = _tokens_idf(on_host(ref_tok["input_ids"]), ref_mask)
        pred_scale = _idf_matrix(on_host(pred_tok["input_ids"]), idf_table) * pred_special
        ref_scale = _idf_matrix(on_host(ref_tok["input_ids"]), idf_table) * ref_special
    else:
        pred_scale, ref_scale = pred_special, ref_special
    pred_scale = pred_scale / np.clip(pred_scale.sum(-1, keepdims=True), 1e-12, None)
    ref_scale = ref_scale / np.clip(ref_scale.sum(-1, keepdims=True), 1e-12, None)

    # ---- embed + score (device) -----------------------------------------
    with torch.no_grad(), full_float32():
        pred_emb = _embed_corpus(
            forward, on_device(pred_tok["input_ids"]), on_device(pred_tok["attention_mask"]), batch_size
        )
        ref_emb = _embed_corpus(forward, on_device(ref_tok["input_ids"]), on_device(ref_tok["attention_mask"]), batch_size)
        precision, recall, f1 = _score_from_embeddings(pred_emb, ref_emb, on_device(pred_scale), on_device(ref_scale))
    del pred_emb, ref_emb

    if rescale_with_baseline:
        if baseline is None and baseline_path is not None:
            baseline = _read_baseline_csv(baseline_path)
        if baseline is None and (baseline_url or (lang and model_name_or_path)):
            # an explicit url, or the official bert-score tree for (lang,
            # model); a failed fetch degrades to the no-baseline warning
            url = baseline_url or f"{_BASELINE_URL_BASE}/{lang}/{model_name_or_path}.tsv"
            try:
                baseline = _read_baseline_url(url)
            except Exception as err:  # noqa: BLE001 - offline or 404 must not stop the scoring
                rank_zero_warn(f"Baseline fetch from {url!r} failed ({err}).")
        if baseline is None:
            rank_zero_warn("Baseline was not successfully loaded. No baseline is going to be used.")
        else:
            precision, recall, f1 = _rescale_with_baseline(
                precision, recall, f1, _as_float32_tensor(baseline).to(device), num_layers, all_layers
            )

    values = torch.stack([precision, recall, f1]).cpu()  # one device-to-host copy
    output_dict = {"precision": values[0].tolist(), "recall": values[1].tolist(), "f1": values[2].tolist()}
    if return_hash:
        output_dict["hash"] = _get_hash(model_name_or_path, num_layers, idf)
    return output_dict
