"""The image family's cases that need the card. They import nothing of JAX,
so that they run on a machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_image_cuda.py

Without a card each skips inside the test.

Tolerance: the Inception features on the card against the port on the CPU
within ``FEATURE_RTOL = 1e-4`` of their largest value: ~95 float32
convolutions deep, each a sum of up to 4,032 products that cuDNN and oneDNN
order differently (some by transforms of their own), ten times the bound
the CPU forward holds against the JAX package (``test_torch_inception.py``).
A TF32 forward (2**-11 a product) misses it by far.
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as port
from metrics_tpu_torch.models.inception import InceptionV3

FEATURE_RTOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_network_follows_the_metric_to_the_card_and_back():
    device = _card()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = port.FID(feature=64, streaming=True)
    net = m.__dict__[m._network_attr]
    assert m.device.type == "cuda" and net.device.type == "cuda"
    m.cpu()
    assert net.device.type == "cpu" and m.real_sum.device.type == "cpu"
    m.cuda()
    m.set_dtype(torch.float16)
    assert net.dtype == torch.float32 and m.real_sum.dtype == torch.float16
    m.update(torch.randint(0, 256, (4, 3, 32, 32), dtype=torch.uint8, device=device), real=True)
    assert m.real_sum.device.type == "cuda"


@pytest.mark.cuda
def test_card_features_match_the_cpu_whatever_the_tf32_flags():
    """The float32 forward runs without TF32 even with PyTorch's default flags
    (cuDNN TF32 on): the card's features equal the CPU's within the bound
    with the flags on and off."""
    device = _card()
    imgs = torch.from_numpy(np.random.RandomState(8).randint(0, 256, (2, 3, 40, 48)).astype(np.uint8))
    cpu = InceptionV3()
    want = cpu(imgs, ("2048",))["2048"]
    card = InceptionV3().to(device)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((False, True), (False, False), (True, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            got = card(imgs.to(device), ("2048",))["2048"].cpu()
            err = float((got - want).abs().max())
            assert err <= FEATURE_RTOL * float(want.abs().max()), (flags, err)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("streaming, method", [(False, "eigh"), (True, "eigh"), (True, "ns")])
def test_fid_compute_on_the_card_matches_float64(streaming, method):
    """FID on the card and on the CPU, each against the same states in
    float64, within the JAX package's bar for the float32 trace term (rtol
    2e-3, atol 1e-3 of tr sqrt(S1 S2), which enters FID twice)."""
    device = _card()
    rng = np.random.RandomState(3)
    real = torch.from_numpy(np.abs(rng.randn(300, 64)).astype(np.float32))
    fake = torch.from_numpy((np.abs(rng.randn(300, 64)) * 1.1).astype(np.float32))
    values = {}
    for name, d in (("card", device), ("cpu", "cpu"), ("float64", "cpu")):
        m = port.FID(lambda x: x, feature_dim=64, streaming=streaming, sqrtm_method=method, device=d)
        m.update(real.to(d), real=True)
        m.update(fake.to(d), real=False)
        if name == "float64":
            m.double()
        values[name] = float(m.compute())
    from metrics_tpu_torch.ops.linalg import trace_sqrtm_product_eigh
    from metrics_tpu_torch.image.fid import _mean_cov

    tr_sqrt = float(trace_sqrtm_product_eigh(_mean_cov(real.double())[1], _mean_cov(fake.double())[1]))
    bar = 2 * (2e-3 * tr_sqrt + 1e-3)
    for name in ("card", "cpu"):
        assert abs(values[name] - values["float64"]) <= bar, (values, bar)


@pytest.mark.cuda
def test_kid_and_is_compute_on_the_card_match_the_cpu():
    """The same subsets and shuffle (ops/prng.py on the card) and float32
    kernels: KID within 3 · 64 · 2**-24 of the kernels' size, IS within 1e-5."""
    device = _card()
    rng = np.random.RandomState(4)
    real = torch.from_numpy(np.abs(rng.randn(300, 64)).astype(np.float32))
    fake = torch.from_numpy((np.abs(rng.randn(300, 64)) * 1.1).astype(np.float32))
    values = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for d in (device, "cpu"):
            kid = port.KID(lambda x: x, subsets=10, subset_size=100, device=d)
            kid.update(real.to(d), real=True)
            kid.update(fake.to(d), real=False)
            inception = port.IS(lambda x: x, splits=4, device=d)
            inception.update(real.to(d) * 3)
            values[str(d)] = [float(v) for v in kid.compute()] + [float(v) for v in inception.compute()]
    kscale = float((real.pow(2).sum(1).mean() / 64 + 1) ** 3)
    got, want = values[str(device)], values["cpu"]
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=3 * 64 * 2.0**-24 * kscale)
    np.testing.assert_allclose(got[2:], want[2:], rtol=0, atol=1e-5)
