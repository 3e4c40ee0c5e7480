from metrics_tpu_torch.text.bert import BERTScore
from metrics_tpu_torch.text.bleu import BLEUScore
from metrics_tpu_torch.text.rouge import ROUGEScore
from metrics_tpu_torch.text.wer import WER

__all__ = ["BERTScore", "BLEUScore", "ROUGEScore", "WER"]
