"""Inception Score module metric.

Counterpart of ``metrics_tpu/image/inception.py``. The shuffle before the
split is ``jax.random.permutation`` bit for bit (``ops/prng.py``), the
splits are ``jnp.array_split``'s (``torch.tensor_split``: the first
``N % splits`` chunks take one row more), and the std is the sample std.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image._extractor import NetworkMetric
from metrics_tpu_torch.image.fid import _feature_network
from metrics_tpu_torch.ops import prng
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class IS(NetworkMetric):
    r"""Inception Score of generated images, ``exp(E_x KL(p(y|x) || p(y)))``,
    mean and std over ``splits`` chunks.

    Args:
        feature: 'logits_unbiased' (default, as torch-fidelity), an integer
            tap, or a callable extractor returning logits.
        splits: number of chunks.
        weights: pretrained Inception checkpoint for the built-in extractor.
        variant: 'fidelity' (default) or 'torchvision'; see :class:`FID`.
        seed: seed of the shuffle before the split (``jax.random``'s).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import numpy as np, torch
        >>> from metrics_tpu_torch import IS
        >>> rng = np.random.RandomState(0)
        >>> probs = lambda x: torch.softmax(x.reshape(x.shape[0], -1), -1)
        >>> inception = IS(feature=probs, splits=2, device="cpu")
        >>> inception.update(torch.from_numpy(rng.rand(16, 3, 2, 2).astype(np.float32)))
        >>> mean, std = inception.compute()
        >>> round(float(mean), 4), round(float(std), 4)
        (1.0002, 0.0)
    """

    def __init__(
        self,
        feature: Union[int, str, Callable] = "logits_unbiased",
        splits: int = 10,
        weights: Optional[Any] = None,
        variant: str = "fidelity",
        seed: int = 42,
        compute_on_step: bool = False,
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
        rank_zero_warn(
            "Metric `IS` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self._set_network("inception", _feature_network(
            feature, weights, variant, self.device, taps=("64", "192", "768", "2048", "logits_unbiased"),
            message=f"Got unknown input to argument `feature`: {feature}"))
        self.splits = splits
        self.seed = seed
        self.add_state("features", [], dist_reduce_fx=None)

    def update(self, imgs: torch.Tensor) -> None:  # type: ignore[override]
        self.features.append(self.inception(imgs))

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(IS mean, IS std) over the splits."""
        features = dim_zero_cat(self.features)
        features = features[prng.permutation(prng.prng_key(self.seed, self.device), features.shape[0])]
        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)
        kl_ = []
        for p, log_p in zip(torch.tensor_split(prob, self.splits), torch.tensor_split(log_prob, self.splits)):
            m_p = p.mean(dim=0, keepdim=True)
            kl = p * (log_p - torch.log(m_p))
            kl_.append(torch.exp(kl.sum(dim=1).mean()))
        kl = torch.stack(kl_)
        return kl.mean(), kl.std(correction=1)
