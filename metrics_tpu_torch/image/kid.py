"""Kernel Inception Distance module metric.

Counterpart of ``metrics_tpu/image/kid.py``. The subsets are drawn with
``ops/prng.py``, which is ``jax.random`` bit for bit, so a ``seed`` gives
the JAX package's subsets and its KID. All ``subsets`` MMD estimates run as
one batched computation (the JAX package's ``vmap``): the kernels of every
subset are three batched matmuls.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image._extractor import NetworkMetric
from metrics_tpu_torch.image.fid import _feature_network
from metrics_tpu_torch.ops import prng
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.device import full_float32
from metrics_tpu_torch.utils.prints import rank_zero_warn


def poly_kernel(f1: torch.Tensor, f2: torch.Tensor, degree: int = 3, gamma: Optional[float] = None,
                coef: float = 1.0) -> torch.Tensor:
    """Polynomial kernel ``(gamma <f1, f2> + coef)^degree`` of ``[..., m, D]``
    feature sets."""
    if gamma is None:
        gamma = 1.0 / f1.shape[-1]
    return (f1 @ f2.transpose(-1, -2) * gamma + coef) ** degree


def maximum_mean_discrepancy(k_xx: torch.Tensor, k_xy: torch.Tensor, k_yy: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD² estimate from ``[..., m, m]`` kernel matrices."""
    m = k_xx.shape[-1]
    kt_xx_sum = k_xx.sum(dim=(-2, -1)) - torch.diagonal(k_xx, dim1=-2, dim2=-1).sum(-1)
    kt_yy_sum = k_yy.sum(dim=(-2, -1)) - torch.diagonal(k_yy, dim1=-2, dim2=-1).sum(-1)
    k_xy_sum = k_xy.sum(dim=(-2, -1))
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def poly_mmd(f_real: torch.Tensor, f_fake: torch.Tensor, degree: int = 3, gamma: Optional[float] = None,
             coef: float = 1.0) -> torch.Tensor:
    """Polynomial-kernel MMD between two feature sets (``[..., m, D]``)."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


class KID(NetworkMetric):
    r"""Kernel Inception Distance: mean and population std of the
    polynomial-kernel MMD over random feature subsets.

    Args:
        feature: Inception tap (64 | 192 | 768 | 2048) or a callable extractor.
        subsets: number of random subsets.
        subset_size: samples per subset.
        degree / gamma / coef: polynomial kernel parameters.
        weights: pretrained Inception checkpoint for the built-in extractor.
        variant: 'fidelity' (default) or 'torchvision'; see :class:`FID`.
        seed: seed of the subset draw (``jax.random``'s, see ``ops/prng.py``).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`.

    Example:
        >>> import numpy as np, torch
        >>> from metrics_tpu_torch import KID
        >>> rng = np.random.RandomState(0)
        >>> feats = lambda x: x.reshape(x.shape[0], -1)   # stand-in extractor
        >>> kid = KID(feature=feats, subsets=3, subset_size=16, device="cpu")
        >>> kid.update(torch.from_numpy(rng.rand(32, 4, 2, 2).astype(np.float32)), real=True)
        >>> kid.update(torch.from_numpy(rng.rand(32, 4, 2, 2).astype(np.float32)), real=False)
        >>> mean, std = kid.compute()
        >>> round(float(mean), 4), round(float(std), 4)
        (0.005, 0.0119)
    """

    def __init__(
        self,
        feature: Union[int, str, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
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
            "Metric `KID` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self._set_network("inception", _feature_network(feature, weights, variant, self.device))
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.subsets = subsets
        self.subset_size = subset_size
        self.degree = degree
        self.gamma = gamma
        self.coef = coef
        self.seed = seed
        self.add_state("real_features", [], dist_reduce_fx=None)
        self.add_state("fake_features", [], dist_reduce_fx=None)

    def update(self, imgs: torch.Tensor, real: bool) -> None:  # type: ignore[override]
        features = self.inception(imgs)
        (self.real_features if real else self.fake_features).append(features)

    def subset_indices(self, n_real: int, n_fake: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``[subsets, subset_size]`` row indices of the real and the fake
        features, as the JAX package draws them: ``PRNGKey(seed)`` split in
        two, each half split per subset, a permutation per subset key."""
        k_real, k_fake = prng.split(prng.prng_key(self.seed, self.device))
        idx_real = prng.permutation(prng.split(k_real, self.subsets), n_real)[:, : self.subset_size]
        idx_fake = prng.permutation(prng.split(k_fake, self.subsets), n_fake)[:, : self.subset_size]
        return idx_real, idx_fake

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(KID mean, KID std) over the random subsets."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)
        n_real, n_fake = real_features.shape[0], fake_features.shape[0]
        if n_real < self.subset_size or n_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        idx_real, idx_fake = self.subset_indices(n_real, n_fake)
        with full_float32():
            kid_scores = poly_mmd(real_features[idx_real], fake_features[idx_fake], self.degree, self.gamma, self.coef)
        return kid_scores.mean(), kid_scores.std(correction=0)
