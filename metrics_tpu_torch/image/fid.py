"""Fréchet Inception Distance module metric.

Counterpart of ``metrics_tpu/image/fid.py``. The Fréchet trace term runs on
the metric's device (``ops/linalg.py``: ``eigh`` or Newton–Schulz), never on
the host. ``streaming=True`` accumulates the Gaussian sufficient statistics
(feature sum, outer-product sum, count) as Kahan-compensated float32 sum
states, with a Kahan-aware ``merge_states``; the default buffers every
feature row in ``None``-reduced list states (gathered whole at a sync). The
moments are float32, as in the JAX package with x64 off, and run as true
float32 on the card (``utils/device.py::full_float32``); states cast to
float64 compute in float64, as the JAX package with x64 on. The Fréchet
trace term runs in float64 from the moments (``_compute_fid``). The
extractor is not state (``image/_extractor.py``).
"""
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from metrics_tpu_torch.image._extractor import NetworkMetric
from metrics_tpu_torch.models.inception import InceptionFeatureExtractor
from metrics_tpu_torch.ops.linalg import check_sqrtm_method, kahan_add, kahan_merge, trace_sqrtm_product
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.device import full_float32

_FEATURE_TAPS = ("64", "192", "768", "2048")
_STREAM_KEYS = ("sum", "sum_comp", "outer", "outer_comp", "n")


def _moment_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, the JAX package's moment dtype with x64 off; float64 when the
    states were cast to it (``set_dtype(torch.float64)``, its x64 on)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _compute_fid(
    mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor, sigma2: torch.Tensor, sqrtm_method: str = "auto"
) -> torch.Tensor:
    r"""Fréchet distance between N(mu1, sigma1) and N(mu2, sigma2):
    ``||mu1-mu2||^2 + Tr(sigma1 + sigma2 - 2 sqrt(sigma1 sigma2))``, in
    float64 from the (float32) moments. The trace of the square root is
    where float32 fails at Inception's 2048 dimensions: on an H100,
    cuSOLVER's float32 ``eigh`` missed the float64 FID by 6x LAPACK's error,
    and the float32 Newton–Schulz iteration stopped 10.7% off (``PERF.md``,
    the image family's findings); the card's float64 units make the float64
    term cheap (a 2048-dim FID ``compute()`` in 40-60 ms)."""
    mu1, sigma1, mu2, sigma2 = (t.to(torch.float64) for t in (mu1, sigma1, mu2, sigma2))
    diff = mu1 - mu2
    tr_covmean = trace_sqrtm_product(sigma1, sigma2, method=sqrtm_method)
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean


def _mean_cov(features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n = features.shape[0]
    mean = features.mean(dim=0)
    diff = features - mean
    return mean, diff.T @ diff / (n - 1)


def _stats_to_mean_cov(
    s: torch.Tensor, s_comp: torch.Tensor, ss: torch.Tensor, ss_comp: torch.Tensor, n: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and covariance from Kahan-compensated sufficient statistics
    (``sum - comp`` is the corrected total)."""
    total = s - s_comp
    total_outer = ss - ss_comp
    mean = total / n
    return mean, (total_outer - n * torch.outer(mean, mean)) / (n - 1)


def _feature_network(feature: Any, weights: Any, variant: str, device: torch.device,
                     taps: Tuple[str, ...] = _FEATURE_TAPS, message: Optional[str] = None) -> Callable:
    """A callable ``feature`` as it is, or the Inception extractor of tap
    ``feature`` on ``device``."""
    if callable(feature):
        return feature
    if isinstance(feature, (int, str)) and str(feature) in taps:
        return InceptionFeatureExtractor(feature=feature, weights=weights, variant=variant, device=device)
    raise ValueError(
        message or f"Integer input to argument `feature` must be one of (64, 192, 768, 2048), got {feature}")


class FID(NetworkMetric):
    r"""Fréchet Inception Distance between real and generated images.

    Args:
        feature: Inception tap (64 | 192 | 768 | 2048) for the built-in
            extractor, or any callable ``imgs -> [N, D] features``.
        weights: pretrained Inception state dict or checkpoint path for the
            built-in extractor (random weights otherwise).
        variant: 'fidelity' (default: torch-fidelity's graph, the one
            published scores use) or 'torchvision'.
        streaming: accumulate Kahan-compensated (sum, outer-product sum,
            count) instead of buffering features: constant memory.
        feature_dim: the feature width, needed by ``streaming=True`` with a
            callable ``feature``.
        sqrtm_method: 'auto' (= 'eigh') | 'eigh' | 'ns' (Newton–Schulz).
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn /
            device: see :class:`~metrics_tpu_torch.Metric`; ``forward`` does
            not compute FID per batch by default.

    Example:
        >>> import numpy as np, torch
        >>> from metrics_tpu_torch import FID
        >>> rng = np.random.RandomState(0)
        >>> feats = lambda x: x.reshape(x.shape[0], -1)   # stand-in extractor
        >>> fid = FID(feature=feats, feature_dim=16, streaming=True, device="cpu")
        >>> fid.update(torch.from_numpy(rng.rand(32, 4, 2, 2).astype(np.float32)), real=True)
        >>> fid.update(torch.from_numpy(rng.rand(32, 4, 2, 2).astype(np.float32) * 0.9 + 0.05), real=False)
        >>> round(float(fid.compute()), 4)
        0.3715
    """

    def __init__(
        self,
        feature: Union[int, str, Callable] = 2048,
        weights: Optional[Any] = None,
        variant: str = "fidelity",
        streaming: bool = False,
        feature_dim: Optional[int] = None,
        sqrtm_method: str = "auto",
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
        # a typo must fail here, not at compute() after an epoch of features
        self.sqrtm_method = check_sqrtm_method(sqrtm_method)
        self._set_network("inception", _feature_network(feature, weights, variant, self.device))
        feat_dim = feature_dim if callable(feature) else int(feature)
        self.streaming = streaming
        if streaming:
            if feat_dim is None:
                raise ValueError(
                    "`streaming=True` requires a known feature dim: pass an integer"
                    " `feature` tap or `feature_dim=` alongside a callable."
                )
            for side in ("real", "fake"):
                for name, shape in (("sum", (feat_dim,)), ("outer", (feat_dim, feat_dim))):
                    self.add_state(f"{side}_{name}", torch.zeros(shape), dist_reduce_fx="sum")
                    # Kahan compensation companions: per-rank comps add under a sync
                    self.add_state(f"{side}_{name}_comp", torch.zeros(shape), dist_reduce_fx="sum")
                self.add_state(f"{side}_n", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("real_features", [], dist_reduce_fx=None)
            self.add_state("fake_features", [], dist_reduce_fx=None)

    def update(self, imgs: torch.Tensor, real: bool) -> None:  # type: ignore[override]
        features = self.inception(imgs)
        side = "real" if real else "fake"
        if not self.streaming:
            getattr(self, f"{side}_features").append(features)
            return
        f = features.to(_moment_dtype(getattr(self, f"{side}_sum")))
        with full_float32():
            outer = f.T @ f
        for name, value in (("sum", f.sum(dim=0)), ("outer", outer)):
            total, comp = kahan_add(getattr(self, f"{side}_{name}"), getattr(self, f"{side}_{name}_comp"), value)
            setattr(self, f"{side}_{name}", total)
            setattr(self, f"{side}_{name}_comp", comp)
        setattr(self, f"{side}_n", getattr(self, f"{side}_n") + f.shape[0])

    def merge_states(self, state_a: Dict[str, Any], state_b: Dict[str, Any]) -> Dict[str, Any]:
        """Kahan-aware merge of the streaming moments: the plain ``a + b``
        of a sum state (forward's accumulation, checkpoint folds) would drop
        the compensation."""
        if not self.streaming:
            return super().merge_states(state_a, state_b)
        out = dict(state_a)
        for side in ("real", "fake"):
            for name in ("sum", "outer"):
                key = f"{side}_{name}"
                out[key], out[f"{key}_comp"] = kahan_merge(
                    state_a[key], state_a[f"{key}_comp"], state_b[key], state_b[f"{key}_comp"]
                )
            out[f"{side}_n"] = state_a[f"{side}_n"] + state_b[f"{side}_n"]
        return out

    def compute(self) -> torch.Tensor:
        with full_float32():
            if self.streaming:
                dtype = _moment_dtype(self.real_sum)
                mean1, cov1 = _stats_to_mean_cov(*(getattr(self, f"real_{k}").to(dtype) for k in _STREAM_KEYS))
                mean2, cov2 = _stats_to_mean_cov(*(getattr(self, f"fake_{k}").to(dtype) for k in _STREAM_KEYS))
            else:
                real, fake = dim_zero_cat(self.real_features), dim_zero_cat(self.fake_features)
                mean1, cov1 = _mean_cov(real.to(_moment_dtype(real)))
                mean2, cov2 = _mean_cov(fake.to(_moment_dtype(fake)))
            return _compute_fid(mean1, cov1, mean2, cov2, self.sqrtm_method).to(torch.float32)
