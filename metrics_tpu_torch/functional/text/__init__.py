from metrics_tpu_torch.functional.text.bert import bert_score
from metrics_tpu_torch.functional.text.bleu import bleu_score
from metrics_tpu_torch.functional.text.rouge import rouge_score
from metrics_tpu_torch.functional.text.wer import wer

__all__ = ["bert_score", "bleu_score", "rouge_score", "wer"]
