"""BERTScore module metric.

Counterpart of ``metrics_tpu/text/bert.py``. The tokenized ids and masks
are proper cat states (``dist_reduce_fx="cat"``; int32 ``[N, max_length]``
from the built-in tokenizer, as in the JAX package), so a distributed
evaluation gathers every rank's sentences before scoring. A user ``model``
is held outside the module tree (``image/_extractor.py``): ``state_dict()``,
checkpoints and the sync payload hold the token states only, and ``.to()``
moves the model along. The encoder and the states live on ``device``.
"""
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.functional.text import bert as _bert
from metrics_tpu_torch.functional.text.bert import SimpleTokenizer, _preprocess_text, bert_score
from metrics_tpu_torch.image._extractor import NetworkMetric
from metrics_tpu_torch.utils.data import dim_zero_cat

_STATES = ("preds_input_ids", "preds_attention_mask", "target_input_ids", "target_attention_mask")


def _as_state(x: np.ndarray) -> np.ndarray:
    """A tokenizer's array with the JAX package's 32-bit dtypes (int64 ids
    of a HF tokenizer become int32, as ``jnp.asarray`` makes them)."""
    if x.dtype == np.int64:
        return x.astype(np.int32)
    if x.dtype == np.float64:
        return x.astype(np.float32)
    return x


class BERTScore(NetworkMetric):
    """BERTScore accumulated over batches of sentence pairs.

    Args:
        model_name_or_path: HF model name or directory (needs
            ``transformers`` and a local checkpoint).
        num_layers: hidden-state index to score with (default: last).
        all_layers: score with every layer.
        model: user model used with ``user_forward_fn``; an ``nn.Module`` is
            moved to ``device``.
        user_tokenizer: callable ``(List[str], max_length) -> dict`` of arrays.
        user_forward_fn: ``(model, batch_dict) -> [B, S, D]`` embeddings.
        idf: inverse-document-frequency token weighting.
        device: where the token states and the encoder live; ``None`` means
            CUDA.
        max_length: pad/truncate length.
        batch_size: embedding-forward chunk size.
        rescale_with_baseline: rescale with ``baseline``/``baseline_path``/``baseline_url``.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn:
            see :class:`~metrics_tpu_torch.Metric`.

    Example (a toy embedding table in place of an encoder):
        >>> import torch
        >>> from metrics_tpu_torch import BERTScore
        >>> table = torch.randn(30522, 8, generator=torch.Generator().manual_seed(0))
        >>> def embed(input_ids, attention_mask):
        ...     return table[input_ids.long()]
        >>> bertscore = BERTScore(model=embed, max_length=16, device="cpu")
        >>> score = bertscore(["hello there", "general kenobi"], ["hello there", "master kenobi"])
        >>> sorted(score.keys()), round(score["f1"][0], 4)
        (['f1', 'precision', 'recall'], 1.0)
    """

    is_differentiable = False

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Any] = None,
        user_tokenizer: Optional[Any] = None,
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
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        if isinstance(model, nn.Module):
            model.to(self.device)
        self._set_network("model", model)
        self.model_name_or_path = model_name_or_path
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.user_forward_fn = user_forward_fn
        self.verbose = verbose
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.return_hash = return_hash
        self.lang = lang
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path
        self.baseline_url = baseline_url
        self.baseline = baseline

        if user_tokenizer is not None:
            self.tokenizer = user_tokenizer
            self.own_tokenizer = True
        elif model_name_or_path is not None and _bert._TRANSFORMERS_AVAILABLE:
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
            self.own_tokenizer = False
        else:
            self.tokenizer = SimpleTokenizer(max_length=max_length)
            self.own_tokenizer = True

        for name in _STATES:
            self.add_state(name, [], dist_reduce_fx="cat")

    def update(self, predictions: List[str], references: List[str]) -> None:  # type: ignore[override]
        """Tokenize on the host and append the batch (``[N, max_length]``
        each, one host-to-device copy per state)."""
        pred_tok = _preprocess_text(list(predictions), self.tokenizer, self.max_length, self.own_tokenizer)
        ref_tok = _preprocess_text(list(references), self.tokenizer, self.max_length, self.own_tokenizer)
        for name, arr in zip(_STATES, (pred_tok["input_ids"], pred_tok["attention_mask"],
                                       ref_tok["input_ids"], ref_tok["attention_mask"])):
            getattr(self, name).append(torch.as_tensor(_as_state(arr), device=self.device))

    def compute(self) -> Dict[str, Union[List[float], str]]:
        predictions = {"input_ids": dim_zero_cat(self.preds_input_ids),
                       "attention_mask": dim_zero_cat(self.preds_attention_mask)}
        references = {"input_ids": dim_zero_cat(self.target_input_ids),
                      "attention_mask": dim_zero_cat(self.target_attention_mask)}
        return bert_score(
            predictions=predictions,
            references=references,
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            all_layers=self.all_layers,
            model=self.model,
            user_tokenizer=self.tokenizer if self.own_tokenizer else None,
            user_forward_fn=self.user_forward_fn,
            verbose=self.verbose,
            idf=self.idf,
            device=self.device,
            max_length=self.max_length,
            batch_size=self.batch_size,
            num_threads=self.num_threads,
            return_hash=self.return_hash,
            lang=self.lang,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline_path=self.baseline_path,
            baseline_url=self.baseline_url,
            baseline=self.baseline,
        )
