from metrics_tpu_torch.models.bert import BertConfig, BertEncoder, load_torch_bert_weights
from metrics_tpu_torch.models.inception import (
    InceptionFeatureExtractor,
    InceptionV3,
    inception_v3_init,
    load_torch_inception_weights,
)
from metrics_tpu_torch.models.lpips_net import LPIPSNetwork, load_torch_lpips_weights, lpips_init

__all__ = [
    "BertConfig",
    "BertEncoder",
    "InceptionFeatureExtractor",
    "InceptionV3",
    "LPIPSNetwork",
    "inception_v3_init",
    "load_torch_bert_weights",
    "load_torch_inception_weights",
    "load_torch_lpips_weights",
    "lpips_init",
]
