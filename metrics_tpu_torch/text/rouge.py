"""ROUGEScore module metric.

Counterpart of ``metrics_tpu/text/rouge.py``. The per-sentence precision,
recall and F1 are float32 cat states, gathered across ranks at
``compute()``, so the distributed mean equals one process's. Each update
appends **one** ``[batch]`` tensor per state (one host-to-device copy each),
where the JAX package appends one ``[1]`` array per sentence: the
concatenated states hold the same values in the same order, and a JAX
checkpoint's per-sentence lists load as they are.
"""
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.rouge import (
    _get_stemmer,
    _parse_rouge_keys,
    _rouge_score_compute,
    _rouge_score_update,
)

_KINDS = ("fmeasure", "precision", "recall")


class ROUGEScore(Metric):
    """ROUGE-N / ROUGE-L / ROUGE-Lsum, averaged over accumulated sentences.

    Args:
        newline_sep: deprecated, warns and does nothing.
        use_stemmer: Porter-stem tokens >3 chars before matching (nltk's
            stemmer when nltk is importable, the built-in one otherwise).
        rouge_keys: ``rouge1``..``rouge9``, ``rougeL``, ``rougeLsum``.
        decimal_places: deprecated, warns and does nothing.
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> from metrics_tpu_torch import ROUGEScore
        >>> targets = ["Is your name John"]
        >>> preds = ["My name is John"]
        >>> rouge = ROUGEScore(rouge_keys="rouge1", device="cpu")
        >>> scores = rouge(preds, targets)
        >>> float(scores["rouge1_fmeasure"])
        0.75
    """

    is_differentiable = False

    def __init__(
        self,
        newline_sep: Optional[bool] = None,  # deprecated (reference v0.6); remove in v0.7
        use_stemmer: bool = False,
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        decimal_places: Optional[bool] = None,  # deprecated (reference v0.6); remove in v0.7
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        import warnings

        if newline_sep is not None:
            warnings.warn("Argument `newline_sep` is deprecated in v0.6 and will be removed in v0.7")
        if decimal_places is not None:
            warnings.warn("Argument `decimal_places` is deprecated in v0.6 and will be removed in v0.7")
        self.rouge_keys, self.rouge_keys_values = _parse_rouge_keys(rouge_keys)
        self.stemmer = _get_stemmer() if use_stemmer else None
        for rouge_key in self.rouge_keys:
            for score in _KINDS:
                self.add_state(f"{rouge_key}_{score}", [], dist_reduce_fx="cat")

    def update(  # type: ignore[override]
        self, preds: Union[str, List[str]], targets: Union[str, List[str]]
    ) -> None:
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(targets, str):
            targets = [targets]
        output = _rouge_score_update(preds, targets, self.rouge_keys_values, stemmer=self.stemmer)
        for rouge_key, metrics in output.items():
            if not metrics:
                continue
            for kind in _KINDS:
                values = torch.tensor([m[kind] for m in metrics], dtype=torch.float32, device=self.device)
                getattr(self, f"rouge{rouge_key}_{kind}").append(values)

    def compute(self) -> Dict[str, torch.Tensor]:
        update_output: Dict[str, torch.Tensor] = {}
        for rouge_key in self.rouge_keys_values:
            for kind in _KINDS:
                scores = getattr(self, f"rouge{rouge_key}_{kind}")
                update_output[f"rouge{rouge_key}_{kind}"] = (
                    torch.cat([s.reshape(-1) for s in scores]) if scores else torch.zeros(0, device=self.device)
                )
        return _rouge_score_compute(update_output)
