"""The JAX suite's golden-score pins (``tests/test_golden_pipeline_scores.py``)
through the port, case for case, on the CPU.

Each case runs a whole pipeline of the port with its default weights (tower
forward, accumulation, moments, trace, MMD or greedy match, the scalar) on
the JAX suite's inputs, and holds the scalar to the JAX suite's pin with the
JAX suite's ``rtol``. The default Inception and LPIPS towers are the JAX
package's draws (``inception_v3_init``, ``lpips_init`` under
``PRNGKey(0)`` through ``ops/prng.py``: within 4 ulps of ``jax.random``),
and so is the default BERT encoder (``bert_init``), so the pins carry over.

Two pins do not carry over, and those two cases hold the port to the
float64 value of the same pipeline on the same features instead, at the
pin's ``rtol`` (an independent numpy/scipy computation): the buffered FID
pin (0.0023627025) is the JAX package's float32 Fréchet trace, 0.41% below
the float64 value 0.00237246 of its own features, and the KID pin
(4.8160553e-05) is its float32 kernel sums, 0.78% below the float64 value
4.85391e-05; each is further from the value it stands for than its own
``rtol``. The port takes the trace in float64 (``image/fid.py::_compute_fid``)
and lands on the float64 FID; its float32 KID sums, in torch's order, land
0.20% from the float64 KID.
"""
import warnings

import numpy as np
import pytest
import scipy.linalg
import torch

from metrics_tpu_torch import FID, IS, KID, LPIPS, BERTScore
from metrics_tpu_torch.models.inception import InceptionFeatureExtractor


def _quiet(make):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make()


def _identity(f):
    return f


def _fid64(real, fake):
    """FID of two feature sets in float64: numpy moments, scipy's sqrtm."""
    real, fake = real.double().numpy(), fake.double().numpy()
    c1, c2 = np.cov(real, rowvar=False), np.cov(fake, rowvar=False)
    diff = real.mean(0) - fake.mean(0)
    return diff @ diff + np.trace(c1) + np.trace(c2) - 2 * np.trace(scipy.linalg.sqrtm(c1 @ c2).real)


def _kid64(real, fake, idx_real, idx_fake):
    """KID mean and population std in float64 over the given subsets: the
    cubic polynomial kernel ``(<x, y> / D + 1)^3``, unbiased MMD."""
    def k(a, b):
        return (a @ np.swapaxes(b, -1, -2) / a.shape[-1] + 1.0) ** 3

    x, y = real.double().numpy()[idx_real.numpy()], fake.double().numpy()[idx_fake.numpy()]
    m = x.shape[1]
    kxx, kyy, kxy = k(x, x), k(y, y), k(x, y)
    off = lambda t: t.sum((-2, -1)) - np.trace(t, axis1=-2, axis2=-1)  # noqa: E731
    mmd = (off(kxx) + off(kyy)) / (m * (m - 1)) - 2 * kxy.sum((-2, -1)) / m**2
    return mmd.mean(), mmd.std()


@pytest.fixture(scope="module")
def stem_features():
    """One 64-tap tower pass (fidelity-variant stem) shared by FID/KID."""
    rng = np.random.RandomState(1234)
    real = torch.from_numpy(rng.randint(0, 256, (24, 3, 64, 64), dtype=np.uint8))
    fake = torch.from_numpy(rng.randint(0, 256, (24, 3, 64, 64), dtype=np.uint8))
    ext = _quiet(lambda: InceptionFeatureExtractor(feature=64, device="cpu"))
    return ext(real), ext(fake)


class TestGoldenImagePipelines:
    def test_fid_streaming(self, stem_features):
        real_f, fake_f = stem_features
        fid = FID(feature=_identity, feature_dim=64, streaming=True, device="cpu")
        fid.update(real_f, True)
        fid.update(fake_f, False)
        np.testing.assert_allclose(float(fid.compute()), 0.002359572798013687, rtol=2e-3)

    def test_fid_cat_matches_streaming_pin(self, stem_features):
        """The buffering path at the pin's rtol, of the float64 FID (the
        JAX pin, 0.0023627025075256824, is 0.41% below it)."""
        real_f, fake_f = stem_features
        fid = FID(feature=_identity, feature_dim=64, device="cpu")
        fid.update(real_f, True)
        fid.update(fake_f, False)
        np.testing.assert_allclose(float(fid.compute()), _fid64(real_f, fake_f), rtol=2e-3)

    def test_kid(self, stem_features):
        real_f, fake_f = stem_features
        kid = KID(feature=_identity, subsets=4, subset_size=16, device="cpu")
        kid.update(real_f, True)
        kid.update(fake_f, False)
        kmean, kstd = kid.compute()
        # at the pins' rtol, of the float64 KID over the same subsets (the JAX
        # pins, 4.8160552978515625e-05 and 2.0462370230234228e-05, are 0.78%
        # and 2.6% from it)
        want_mean, want_std = _kid64(real_f, fake_f, *kid.subset_indices(24, 24))
        np.testing.assert_allclose(float(kmean), want_mean, rtol=5e-3)
        np.testing.assert_allclose(float(kstd), want_std, rtol=5e-3)

    def test_lpips(self):
        lp = _quiet(lambda: LPIPS(net_type="alex", device="cpu"))
        a = torch.from_numpy(np.random.RandomState(5).rand(4, 3, 64, 64).astype(np.float32) * 2 - 1)
        b = torch.from_numpy(np.random.RandomState(6).rand(4, 3, 64, 64).astype(np.float32) * 2 - 1)
        lp.update(a, b)
        np.testing.assert_allclose(float(lp.compute()), 0.13386474549770355, rtol=1e-3)


class TestGoldenTextPipeline:
    def test_bertscore_default_encoder(self):
        bs = BERTScore(max_length=32, device="cpu")
        bs.update(
            ["the quick brown fox jumps over the lazy dog", "hello world"],
            ["a quick brown fox jumped over lazy dogs", "hello there world"],
        )
        res = bs.compute()
        np.testing.assert_allclose(float(np.mean(res["f1"])), 0.8212698400020599, rtol=1e-4)
        np.testing.assert_allclose(float(np.mean(res["precision"])), 0.8291044235229492, rtol=1e-4)


@pytest.mark.slow
class TestGoldenFullGraph:
    def test_inception_score_full_tower(self):
        """The full 1008-logit fidelity graph end to end (under ``-m slow``,
        as in the JAX suite)."""
        rng = np.random.RandomState(1234)
        real = torch.from_numpy(rng.randint(0, 256, (24, 3, 64, 64), dtype=np.uint8))
        fake = torch.from_numpy(rng.randint(0, 256, (24, 3, 64, 64), dtype=np.uint8))
        isc = _quiet(lambda: IS(splits=2, device="cpu"))
        isc.update(torch.cat([real[:8], fake[:8]], dim=0))
        imean, istd = isc.compute()
        np.testing.assert_allclose(float(imean), 1.0000107288360596, rtol=1e-4)
        assert float(istd) < 1e-4  # near-uniform logits from the deterministic init
