"""The image family of the port against the JAX package, on the CPU:
``image_gradients``, PSNR (the ``data_range``/``base``/``dim``/
``reduction`` cases of ``tests/image/test_psnr_matrix.py``), SSIM (the
shapes and sigmas of ``tests/image/test_ssim_oracle.py``, its streaming and
list branches), ``ops/linalg.py`` (the ill-conditioned and rank-deficient
cases of ``tests/image/test_fid_precision.py``), FID, KID and IS with a
callable extractor (streaming against buffered, the Kahan merge, the
``ValueError``s), LPIPS with a callable network; then the rule that a
metric's network is not its state, JAX checkpoints of SSIM, PSNR and
streaming FID loading into the port, and two ranks on the thread world
with a fold of their checkpoint shards 2 → 1. The networks themselves are in
``test_torch_inception.py`` and ``test_torch_lpips.py``.

Inputs come from seeded numpy; each JAX metric runs on one batch shape, so
its ops compile once.

Tolerances, each against the JAX package unless stated:

- gradients: exact (one float32 subtraction per value).
- PSNR ``PSNR_ATOL = 1e-5`` dB: the value is ``10/ln(base) · ln(range² ·
  N / SSE)``; the SSE of at most 128 float32 terms differs by at most
  log2(128) = 7 roundings of 2**-24 between the two summation orders,
  ln moves by that relative error, times 10/ln(2) = 14.4 at most: 6e-6.
- SSIM ``SSIM_ATOL = 1e-5``: each window statistic sums 121 float32
  products (7 roundings each way), the index is a quotient of products of
  differences of them (~10 such terms), the mean over ≤ 2,000 values; the
  bound is ~20 · 2**-24 · 7 = 8e-6 of values of size ≤ 1.
- linalg: Kahan sums exact (the same elementwise float32 operations);
  ``sqrtm_newton_schulz`` and the trace paths against the JAX package within
  ``rtol=2e-3, atol=1e-3``, the bar the JAX package's own tests hold both
  against scipy's float64 (the two sides run different LAPACK ``eigh``s in
  float32, each within that bar of the truth), and against scipy at the
  same bar.
- FID ``FID_RTOL = 1e-4``: FID (~6.9 here) is a difference of traces of
  size ~50; float32 moments and the JAX package's float32 ``eigh`` of a
  12x12 covariance with variances over one decade carry ~50 · 2**-24 · 12
  · 4 = 1.4e-4 of roundoff into it, 2e-5 of the value (the port takes the
  trace term in float64; the two packages were 4.2e-5 apart at most, the
  JAX package 3.4e-5 and the port 8.5e-6 from scipy's float64).
- KID ``KID_ATOL = 3e-5`` and IS ``STAT_ATOL = 1e-6``: the subsets and the
  shuffle are the same integers (``ops/prng.py``). KID is a difference of
  three means of ≤ 256 kernel values of size ≤ K = 16 (degree 2, gamma
  0.5, coef 2), each mean off by ≤ log2(256) = 8 roundings of 2**-24
  relative: 3 · 16 · 8 · 6e-8 = 2.3e-5. IS means softmax terms of size ≤ 1.
"""
import json
import math
import struct
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import linalg as scipy_linalg

import metrics_tpu as ref
import metrics_tpu.functional as ref_f
import metrics_tpu_torch as port
import metrics_tpu_torch.functional as port_f
from metrics_tpu.ops import linalg as ref_linalg
from metrics_tpu_torch import load_checkpoint, save_checkpoint
from metrics_tpu_torch.ops import linalg as port_linalg
from metrics_tpu_torch.parallel.bucketing import clear_sync_plan_cache
from tests.helpers.torch_world import TorchLockstepWorld

PSNR_ATOL, SSIM_ATOL, FID_RTOL, KID_ATOL, STAT_ATOL = 1e-5, 1e-5, 1e-4, 3e-5, 1e-6
LINALG_RTOL, LINALG_ATOL = 2e-3, 1e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol, rtol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _quiet(make):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return make()


# ---------------------------------------------------------------------------
# image_gradients
# ---------------------------------------------------------------------------

def test_image_gradients_match_reference():
    img = np.random.RandomState(0).rand(2, 3, 5, 7).astype(np.float32)
    for got, want in zip(port_f.image_gradients(_t(img)), ref_f.image_gradients(jnp.asarray(img))):
        assert np.array_equal(_np(got), _np(want))


def test_image_gradients_reject_non_4d():
    with pytest.raises(RuntimeError, match="Expected BxCxHxW"):
        port_f.image_gradients(torch.zeros(3, 4, 4))
    with pytest.raises(RuntimeError, match="Expected BxCxHxW"):
        ref_f.image_gradients(jnp.zeros((3, 4, 4)))


# ---------------------------------------------------------------------------
# PSNR: the cases of tests/image/test_psnr_matrix.py
# ---------------------------------------------------------------------------

_rng = np.random.RandomState(42)
_PSNR_SIZE = (2, 8, 4, 4)  # two batches of [8, 4, 4]
PSNR_INPUTS = [
    ((_rng.randint(p, size=_PSNR_SIZE) / p).astype(np.float32),
     (_rng.randint(t, size=_PSNR_SIZE) / t).astype(np.float32))
    for p, t in [(10, 10), (5, 10), (10, 5)]
]
PSNR_CASES = [(0, 1.0, None), (1, 1.0, None), (2, 0.5, None), (2, 0.5, (1, 2)), (0, None, None)]


@pytest.mark.parametrize("base", [10.0, math.e])
@pytest.mark.parametrize("case", range(len(PSNR_CASES)))
def test_psnr_functional_matches_reference(case, base):
    idx, data_range, dim = PSNR_CASES[case]
    preds, target = PSNR_INPUTS[idx]
    got = port_f.psnr(_t(preds[0]), _t(target[0]), data_range=data_range, base=base, dim=dim)
    want = ref_f.psnr(jnp.asarray(preds[0]), jnp.asarray(target[0]), data_range=data_range, base=base, dim=dim)
    _close(got, want, PSNR_ATOL)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_psnr_functional_reductions_over_dim(reduction):
    preds, target = PSNR_INPUTS[0]
    kw = dict(data_range=1.0, reduction=reduction, dim=(1, 2))
    want = ref_f.psnr(jnp.asarray(preds[0]), jnp.asarray(target[0]), **kw)
    _close(port_f.psnr(_t(preds[0]), _t(target[0]), **kw), want, PSNR_ATOL)


@pytest.mark.parametrize("base", [10.0, math.e])
@pytest.mark.parametrize("case", range(len(PSNR_CASES)))
def test_psnr_module_matches_reference(case, base):
    idx, data_range, dim = PSNR_CASES[case]
    preds, target = PSNR_INPUTS[idx]
    m_port = port.PSNR(data_range=data_range, base=base, dim=dim, device="cpu")
    m_ref = ref.PSNR(data_range=data_range, base=base, dim=dim)
    for b in range(2):
        _close(m_port(_t(preds[b]), _t(target[b])), m_ref(jnp.asarray(preds[b]), jnp.asarray(target[b])), PSNR_ATOL)
    _close(m_port.compute(), m_ref.compute(), PSNR_ATOL)
    for name, v in m_ref._state.items():
        got = getattr(m_port, name)
        if isinstance(v, list):
            assert len(got) == len(v)
        else:
            assert got.dtype == torch.float32, name  # every state float32, the count too
            _close(got, v, 1e-6 * max(1.0, float(np.abs(_np(v)))))


@pytest.mark.parametrize("reduction", ["none", "sum"])
def test_psnr_reduction_for_dim_none_warns(reduction):
    with pytest.warns(UserWarning, match="will not have any effect"):
        port.PSNR(reduction=reduction, dim=None, device="cpu")


def test_psnr_dim_requires_data_range():
    with pytest.raises(ValueError, match="data_range"):
        port.PSNR(dim=(1, 2), device="cpu")
    with pytest.raises(ValueError, match="data_range"):
        port_f.psnr(torch.zeros(2, 2), torch.zeros(2, 2), dim=1)


def test_psnr_total_is_a_float32_count_that_rounds_as_the_reference():
    """Past 2**24 the float32 count rounds; the port's rounds the same way
    (here 3 updates of 2**24 + 1 elements each, without the pixels: the
    update adds the count of the target's shape)."""
    m_port, m_ref = port.PSNR(data_range=1.0, device="cpu"), ref.PSNR(data_range=1.0)
    n = 2**24 + 1
    m_port.total = torch.tensor(float(2**25), dtype=torch.float32)
    m_ref.total = jnp.asarray(float(2**25), dtype=jnp.float32)
    for _ in range(3):
        m_port.total = m_port.total + torch.tensor(n)
        m_ref.total = m_ref.total + jnp.asarray(n)
    assert m_port.total.dtype == torch.float32
    assert float(m_port.total) == float(m_ref.total) != 2**25 + 3 * n


# ---------------------------------------------------------------------------
# SSIM: the shapes and sigmas of tests/image/test_ssim_oracle.py
# ---------------------------------------------------------------------------

SSIM_SHAPES = {"gray": (2, 1, 24, 24), "rgb_rect": (1, 3, 32, 20)}
SSIM_KERNELS = {"default": ((11, 11), (1.5, 1.5)), "asym": ((7, 5), (1.0, 2.0))}


def _ssim_pair(shape, seed=123):
    rng = np.random.RandomState(seed)
    preds = rng.rand(*shape).astype(np.float32)
    target = np.clip(preds + rng.randn(*shape).astype(np.float32) * 0.1, 0, 1)
    return preds, target


@pytest.mark.parametrize("data_range", [1.0, None])
@pytest.mark.parametrize("kernel", list(SSIM_KERNELS))
@pytest.mark.parametrize("shape", list(SSIM_SHAPES))
def test_ssim_functional_matches_reference(shape, kernel, data_range):
    preds, target = _ssim_pair(SSIM_SHAPES[shape])
    kernel_size, sigma = SSIM_KERNELS[kernel]
    kw = dict(kernel_size=kernel_size, sigma=sigma, data_range=data_range)
    want = ref_f.ssim(jnp.asarray(preds), jnp.asarray(target), **kw)
    _close(port_f.ssim(_t(preds), _t(target), **kw), want, SSIM_ATOL)


@pytest.mark.parametrize("reduction", ["sum", "none"])
def test_ssim_functional_reductions(reduction):
    preds, target = _ssim_pair(SSIM_SHAPES["gray"])
    kw = dict(data_range=1.0, reduction=reduction)
    want = ref_f.ssim(jnp.asarray(preds), jnp.asarray(target), **kw)
    _close(port_f.ssim(_t(preds), _t(target), **kw), want, SSIM_ATOL * (1 if reduction == "none" else 2 * 14 * 14))


def test_ssim_gaussian_window_matches_reference():
    from metrics_tpu.functional.image.ssim import _gaussian_kernel as ref_kernel
    from metrics_tpu_torch.functional.image.ssim import _gaussian_kernel

    got = _gaussian_kernel(3, (7, 5), (1.0, 2.0), torch.float32, torch.device("cpu"))
    want = ref_kernel(3, (7, 5), (1.0, 2.0), jnp.float32)
    assert np.array_equal(_np(got), _np(want))


@pytest.mark.parametrize("data_range, reduction", [(1.0, "elementwise_mean"), (1.0, "sum"), (None, "elementwise_mean"),
                                                   (1.0, "none")])
def test_ssim_module_both_branches_match_reference(data_range, reduction):
    """``data_range`` with a mean or sum reduction streams into two sum
    states; otherwise every input is buffered (the list branch)."""
    m_port = _quiet(lambda: port.SSIM(data_range=data_range, reduction=reduction, device="cpu"))
    m_ref = _quiet(lambda: ref.SSIM(data_range=data_range, reduction=reduction))
    assert m_port._streaming == m_ref._streaming == (data_range is not None and reduction != "none")
    rng = np.random.RandomState(125)
    for _ in range(3):
        p = rng.rand(2, 1, 24, 24).astype(np.float32)
        t = np.clip(p + rng.randn(2, 1, 24, 24).astype(np.float32) * 0.05, 0, 1)
        m_port.update(_t(p), _t(t))
        m_ref.update(jnp.asarray(p), jnp.asarray(t))
    atol = SSIM_ATOL * (3 * 2 * 14 * 14 if reduction == "sum" else 1)
    _close(m_port.compute(), m_ref.compute(), atol)
    assert sorted(m_port._defaults) == sorted(m_ref._state)
    if m_port._streaming:
        assert m_port.total.dtype == torch.float32 and float(m_port.total) == float(m_ref.total)


def test_ssim_streaming_equals_list_branch():
    """The streaming sum states and the buffered branch agree on the same
    batches (the JAX package's own check)."""
    stream = port.SSIM(data_range=1.0, device="cpu")
    buffered = _quiet(lambda: port.SSIM(data_range=1.0, reduction="none", device="cpu"))
    rng = np.random.RandomState(7)
    for _ in range(2):
        p = _t(rng.rand(2, 3, 20, 20).astype(np.float32))
        t = _t(rng.rand(2, 3, 20, 20).astype(np.float32))
        stream.update(p, t)
        buffered.update(p, t)
    _close(stream.compute(), buffered.compute().mean(), SSIM_ATOL)


@pytest.mark.parametrize("kw, err, match", [
    (dict(kernel_size=(11,)), ValueError, "length of two"),
    (dict(kernel_size=(10, 11)), ValueError, "odd positive"),
    (dict(sigma=(1.5, 0.0)), ValueError, "positive number"),
])
def test_ssim_argument_errors_match_reference(kw, err, match):
    x = np.random.RandomState(1).rand(1, 1, 16, 16).astype(np.float32)
    with pytest.raises(err, match=match):
        port_f.ssim(_t(x), _t(x), **kw)
    with pytest.raises(err, match=match):
        ref_f.ssim(jnp.asarray(x), jnp.asarray(x), **kw)


def test_ssim_input_errors():
    with pytest.raises(TypeError, match="same data type"):
        port_f.ssim(torch.zeros(1, 1, 16, 16), torch.zeros(1, 1, 16, 16, dtype=torch.float64))
    with pytest.raises(ValueError, match="BxCxHxW"):
        port_f.ssim(torch.zeros(1, 16, 16), torch.zeros(1, 16, 16))
    with pytest.raises(RuntimeError, match="same shape"):
        port_f.ssim(torch.zeros(1, 1, 16, 16), torch.zeros(1, 1, 16, 15))


# ---------------------------------------------------------------------------
# ops/linalg.py: the cases of tests/image/test_fid_precision.py
# ---------------------------------------------------------------------------

def test_kahan_add_and_merge_match_reference_bit_for_bit():
    rng = np.random.RandomState(3)
    total, comp, value = (rng.randn(16).astype(np.float32) * s for s in (1e6, 1.0, 1e-2))
    for got, want in zip(port_linalg.kahan_add(_t(total), _t(comp), _t(value)),
                         ref_linalg.kahan_add(jnp.asarray(total), jnp.asarray(comp), jnp.asarray(value))):
        assert np.array_equal(_np(got), _np(want))
    b_total, b_comp = rng.randn(16).astype(np.float32) * 3, rng.randn(16).astype(np.float32) * 0.25
    args = (total, comp, b_total, b_comp)
    for got, want in zip(port_linalg.kahan_merge(*map(_t, args)), ref_linalg.kahan_merge(*map(jnp.asarray, args))):
        assert np.array_equal(_np(got), _np(want))


def test_kahan_add_rescues_a_float32_sum():
    total, comp, naive = torch.tensor(1e8), torch.tensor(0.0), torch.tensor(1e8)
    for _ in range(1000):
        total, comp = port_linalg.kahan_add(total, comp, torch.tensor(1.0))
        naive = naive + 1.0
    assert abs(float(total - comp) - (1e8 + 1000)) < 64.0
    assert abs(float(naive) - 1e8) < 1.0


def _spd(rng, d, cond):
    q, _ = np.linalg.qr(rng.randn(d, d))
    return (q * np.logspace(0, -np.log10(cond), d)) @ q.T


def _linalg_cases():
    rng = np.random.RandomState(2)
    cases = {}
    for exp in (4, 8):  # the ill-conditioned pairs of test_trace_sqrtm_product_ill_conditioned
        q1, _ = np.linalg.qr(rng.randn(24, 24))
        q2, _ = np.linalg.qr(rng.randn(24, 24))
        e = np.logspace(-exp / 2, exp / 2, 24)
        cases[f"cond1e{exp}"] = ((q1 * e) @ q1.T, (q2 * e[::-1]) @ q2.T)
    rng = np.random.RandomState(11)  # rank 7 in 64 dims: sample covariances of N < D
    cases["rank_deficient"] = (np.cov(rng.randn(8, 64).T), np.cov((rng.randn(8, 64) * 1.2 + 0.3).T))
    rng = np.random.RandomState(17)
    cases["ns_cond1e5"] = (_spd(rng, 64, 1e5), _spd(rng, 64, 1e5) + 0.05 * _spd(rng, 64, 1e5))
    return {k: (a.astype(np.float32), b.astype(np.float32)) for k, (a, b) in cases.items()}


LINALG_CASES = _linalg_cases()


# float32 eigh misses scipy on the rank-deficient case in both packages (the
# JAX package's test_ns_beats_eigh_f32_on_extreme_rank_deficiency): there
# eigh is held against the JAX value alone, below
LINALG_PAIRS = [(c, m) for c in LINALG_CASES for m in ("eigh", "ns", "auto")
                if not (c == "rank_deficient" and m != "ns")]


@pytest.mark.parametrize("case, method", LINALG_PAIRS)
def test_trace_sqrtm_product_matches_reference_and_scipy(case, method):
    s1, s2 = LINALG_CASES[case]
    got = port_linalg.trace_sqrtm_product(_t(s1), _t(s2), method=method)
    ref_method = "eigh" if method == "auto" else method
    want = ref_linalg.trace_sqrtm_product(jnp.asarray(s1), jnp.asarray(s2), method=ref_method)
    exact = np.trace(scipy_linalg.sqrtm(s1.astype(np.float64) @ s2.astype(np.float64)).real)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got))
    _close(got, want, LINALG_ATOL, LINALG_RTOL)
    _close(got, np.asarray(exact, np.float32), LINALG_ATOL, LINALG_RTOL)


def test_trace_sqrtm_product_eigh_on_rank_deficient_matches_reference():
    s1, s2 = LINALG_CASES["rank_deficient"]
    got = port_linalg.trace_sqrtm_product_eigh(_t(s1), _t(s2))
    want = ref_linalg.trace_sqrtm_product_eigh(jnp.asarray(s1), jnp.asarray(s2))
    _close(got, want, LINALG_ATOL, LINALG_RTOL)


def test_sqrtm_newton_schulz_matches_reference():
    a = _spd(np.random.RandomState(4), 16, 1e2).astype(np.float32)
    got = port_linalg.sqrtm_newton_schulz(_t(a))
    _close(got, ref_linalg.sqrtm_newton_schulz(jnp.asarray(a)), LINALG_ATOL, LINALG_RTOL)
    _close(got @ got, a, 1e-4)


@pytest.mark.parametrize("method", ["eigh", "ns"])
def test_zero_covariance_gives_zero_not_nan(method):
    z = torch.zeros(8, 8)
    assert float(port_linalg.trace_sqrtm_product(z, z, method=method)) == 0.0


def test_unknown_sqrtm_method_raises():
    with pytest.raises(ValueError, match="unknown sqrtm method"):
        port_linalg.trace_sqrtm_product(torch.eye(4), torch.eye(4), method="qr")
    with pytest.raises(ValueError, match="unknown sqrtm method"):
        port.FID(feature=lambda x: x, sqrtm_method="qr", device="cpu")


# ---------------------------------------------------------------------------
# FID, KID, IS with a callable extractor; LPIPS with a callable network
# ---------------------------------------------------------------------------

D, FEAT_BATCH, FEAT_BATCHES = 12, 50, 6
_frng = np.random.RandomState(9)
# a common offset (the cancellation of E[xx^T] - mu mu^T in float32, which
# the Kahan states carry) and variances over one decade: a covariance whose
# float32 eigh is accurate, so the packages differ by roundoff only (the
# ill-conditioned cases are the linalg tests' above)
_STDS = np.logspace(-0.5, 0.5, D)
REAL = (20.0 + _STDS * _frng.randn(FEAT_BATCHES, FEAT_BATCH, D)).astype(np.float32)
FAKE = (20.5 + 1.3 * _STDS * _frng.randn(FEAT_BATCHES, FEAT_BATCH, D)).astype(np.float32)


def _identity(x):
    return x


def _feed_fid(m, to, batches=range(FEAT_BATCHES)):
    for b in batches:
        m.update(to(REAL[b]), real=True)
        m.update(to(FAKE[b]), real=False)
    return m


def _np_fid_f64(real, fake):
    r, f = real.reshape(-1, D).astype(np.float64), fake.reshape(-1, D).astype(np.float64)
    c1, c2 = np.cov(r, rowvar=False), np.cov(f, rowvar=False)
    covmean = scipy_linalg.sqrtm(c1 @ c2).real
    return float(((r.mean(0) - f.mean(0)) ** 2).sum() + np.trace(c1 + c2 - 2.0 * covmean))


@pytest.mark.parametrize("sqrtm_method", ["auto", "ns"])
@pytest.mark.parametrize("streaming", [False, True])
def test_fid_matches_reference(streaming, sqrtm_method):
    kw = dict(feature=_identity, feature_dim=D, streaming=streaming, sqrtm_method=sqrtm_method)
    got = _feed_fid(port.FID(device="cpu", **kw), _t).compute()
    want = _feed_fid(ref.FID(**kw), jnp.asarray).compute()
    assert got.dtype == torch.float32
    _close(got, want, 0.0, FID_RTOL)
    _close(got, np.float32(_np_fid_f64(REAL, FAKE)), 1e-3, 1e-3)  # the JAX package's bar against float64


def test_fid_streaming_states_are_float32_and_match_reference():
    m_port = _feed_fid(port.FID(feature=_identity, feature_dim=D, streaming=True, device="cpu"), _t)
    m_ref = _feed_fid(ref.FID(feature=_identity, feature_dim=D, streaming=True), jnp.asarray)
    assert sorted(m_port._defaults) == sorted(m_ref._state)
    for name, v in m_ref._state.items():
        got = getattr(m_port, name)
        assert got.dtype == torch.float32, name
        if name.endswith("_n"):
            assert float(got) == float(v) == FEAT_BATCHES * FEAT_BATCH
    for side in ("real", "fake"):
        for base in ("sum", "outer"):
            corrected = _np(getattr(m_port, f"{side}_{base}")) - _np(getattr(m_port, f"{side}_{base}_comp"))
            want = _np(m_ref._state[f"{side}_{base}"]) - _np(m_ref._state[f"{side}_{base}_comp"])
            _close(corrected, want, 0.0, 1e-6)


def test_fid_streaming_equals_buffered():
    stream = _feed_fid(port.FID(feature=_identity, feature_dim=D, streaming=True, device="cpu"), _t)
    buffered = _feed_fid(port.FID(feature=_identity, feature_dim=D, device="cpu"), _t)
    _close(stream.compute(), buffered.compute(), 0.0, FID_RTOL)


def test_fid_merge_chain_keeps_the_kahan_rescue():
    """``forward``'s accumulation is ``merge_states(acc, batch)``: the
    Kahan-aware merge must match the JAX package's merge chain and the
    float64 value."""
    kw = dict(feature=_identity, feature_dim=D, streaming=True)
    m_port, scratch_port = port.FID(device="cpu", **kw), port.FID(device="cpu", **kw)
    m_ref, scratch_ref = ref.FID(**kw), ref.FID(**kw)
    state_ref = m_ref.init_state()
    for b in range(FEAT_BATCHES):
        scratch_port.reset()
        _feed_fid(scratch_port, _t, [b])
        m_port.merge_state(scratch_port)
        batch = scratch_ref.pure_update(scratch_ref.init_state(), jnp.asarray(REAL[b]), True)
        batch = scratch_ref.pure_update(batch, jnp.asarray(FAKE[b]), False)
        state_ref = m_ref.merge_states(state_ref, batch)
    _close(m_port.compute(), m_ref.pure_compute(state_ref), 0.0, FID_RTOL)


def test_fid_forward_accumulates_without_computing():
    m = port.FID(feature=_identity, feature_dim=D, streaming=True, device="cpu")
    assert m(_t(REAL[0]), real=True) is None  # compute_on_step=False by default
    m(_t(FAKE[0]), real=False)
    assert float(m.real_n) == float(m.fake_n) == FEAT_BATCH


@pytest.mark.parametrize("kw, match", [
    (dict(feature=65), "must be one of"),
    (dict(feature="logits"), "must be one of"),
    (dict(feature=_identity, streaming=True), "requires a known feature dim"),
])
def test_fid_construction_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        port.FID(device="cpu", **kw)


def _kid_pair(m, to):
    rng = np.random.RandomState(13)
    m.update(to(rng.rand(40, D).astype(np.float32)), real=True)
    m.update(to(rng.rand(36, D).astype(np.float32) * 1.2), real=False)
    return m


@pytest.mark.parametrize("degree, gamma, coef", [(3, None, 1.0), (2, 0.5, 2.0)])
def test_kid_matches_reference_for_the_same_seed(degree, gamma, coef):
    kw = dict(feature=_identity, subsets=5, subset_size=16, degree=degree, gamma=gamma, coef=coef, seed=42)
    got = _kid_pair(_quiet(lambda: port.KID(device="cpu", **kw)), _t).compute()
    want = _kid_pair(_quiet(lambda: ref.KID(**kw)), jnp.asarray).compute()
    for g, w in zip(got, want):
        _close(g, w, KID_ATOL)


def test_kid_batched_mmd_equals_the_loop():
    rng = np.random.RandomState(1)
    a, b = _t(rng.rand(4, 16, D).astype(np.float32)), _t(rng.rand(4, 16, D).astype(np.float32))
    from metrics_tpu_torch.image.kid import poly_mmd

    batched = poly_mmd(a, b)
    for i in range(4):
        _close(batched[i], poly_mmd(a[i], b[i]), 1e-6)


def test_kid_errors():
    m = _kid_pair(_quiet(lambda: port.KID(feature=_identity, subsets=2, subset_size=37, device="cpu")), _t)
    with pytest.raises(ValueError, match="smaller than the number of samples"):
        m.compute()
    for kw in (dict(subsets=0), dict(subset_size=-1), dict(degree=0), dict(gamma=1), dict(coef=0.0)):
        with pytest.raises(ValueError, match="expected to be"):
            _quiet(lambda: port.KID(feature=_identity, device="cpu", **kw))
    with pytest.raises(ValueError, match="must be one of"):
        _quiet(lambda: port.KID(feature=100, device="cpu"))


@pytest.mark.parametrize("n, splits", [(22, 4), (30, 3), (7, 7)])
def test_is_matches_reference_for_the_same_seed(n, splits):
    """``tensor_split`` splits as ``jnp.array_split``: the first ``n % splits``
    chunks take one row more."""
    logits = np.random.RandomState(n).randn(n, 8).astype(np.float32) * 2
    m_port = _quiet(lambda: port.IS(feature=_identity, splits=splits, device="cpu"))
    m_ref = _quiet(lambda: ref.IS(feature=_identity, splits=splits))
    m_port.update(_t(logits))
    m_ref.update(jnp.asarray(logits))
    for g, w in zip(m_port.compute(), m_ref.compute()):
        _close(g, w, STAT_ATOL)


def test_is_feature_errors():
    with pytest.raises(ValueError, match="unknown input to argument `feature`"):
        _quiet(lambda: port.IS(feature="logits", device="cpu"))


def _lpips_dist(x, y):
    return torch.mean((x - y) ** 2, dim=(1, 2, 3))


def _ref_lpips_dist(x, y):
    return jnp.mean((x - y) ** 2, axis=(1, 2, 3))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_lpips_with_a_callable_network_matches_reference(reduction):
    rng = np.random.RandomState(0)
    m_port = port.LPIPS(net=_lpips_dist, reduction=reduction, device="cpu")
    m_ref = ref.LPIPS(net=_ref_lpips_dist, reduction=reduction)
    for _ in range(2):
        a = rng.rand(3, 3, 8, 8).astype(np.float32) * 2 - 1
        b = rng.rand(3, 3, 8, 8).astype(np.float32) * 2 - 1
        _close(m_port(_t(a), _t(b)), m_ref(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    _close(m_port.compute(), m_ref.compute(), 1e-6)
    assert float(m_port.total) == 6.0 and m_port.total.dtype == torch.float32


@pytest.mark.parametrize("a, b", [
    (torch.full((2, 3, 8, 8), 1.5), torch.zeros(2, 3, 8, 8)),
    (torch.zeros(2, 3, 8, 8), torch.full((2, 3, 8, 8), -1.01)),
    (torch.zeros(2, 1, 8, 8), torch.zeros(2, 1, 8, 8)),
    (torch.zeros(3, 8, 8), torch.zeros(3, 8, 8)),
])
def test_lpips_invalid_images_raise(a, b):
    m = port.LPIPS(net=_lpips_dist, device="cpu")
    with pytest.raises(ValueError, match="normalized tensors"):
        m.update(a, b)


def test_lpips_reduction_error():
    with pytest.raises(ValueError, match="reduction"):
        port.LPIPS(net=_lpips_dist, reduction="max", device="cpu")


# ---------------------------------------------------------------------------
# the network is not state
# ---------------------------------------------------------------------------

def _network_metrics():
    """Each class with its built-in network (the port) and the JAX class
    with a stand-in callable (the same states, without a JAX network)."""
    return {
        "fid": (lambda: port.FID(feature=64, streaming=True, device="cpu"),
                lambda: ref.FID(feature=_identity, feature_dim=64, streaming=True)),
        "fid_buffered": (lambda: port.FID(feature=64, device="cpu"), lambda: ref.FID(feature=_identity)),
        "kid": (lambda: port.KID(feature=64, device="cpu"), lambda: ref.KID(feature=_identity)),
        "is": (lambda: port.IS(device="cpu"), lambda: ref.IS(feature=_identity)),
        "lpips": (lambda: port.LPIPS(device="cpu"), lambda: ref.LPIPS(net=_ref_lpips_dist)),
    }


@pytest.fixture(scope="module")
def network_metrics():
    return {k: (_quiet(a), _quiet(b)) for k, (a, b) in _network_metrics().items()}


def _network(m):
    return m.__dict__[m._network_attr]


@pytest.mark.parametrize("name", list(_network_metrics()))
def test_network_is_outside_the_module_tree_and_the_state_dict(network_metrics, name):
    m, m_ref = network_metrics[name]
    net = _network(m)
    assert isinstance(net, torch.nn.Module) and sum(p.numel() for p in net.parameters()) > 1_000_000
    assert list(m.children()) == [] and list(m.parameters()) == []
    m.persistent(True)
    try:
        assert sorted(m.state_dict()) == sorted(m_ref._state)
    finally:
        m.persistent(False)
    assert sorted(part[0] for part in m.state_fingerprint()) == sorted(m_ref._state)


@pytest.mark.parametrize("name", list(_network_metrics()))
def test_set_dtype_casts_the_states_only(name):
    m = _quiet(_network_metrics()[name][0])
    net = _network(m)
    m.set_dtype(torch.float16)
    assert all(v.dtype == torch.float16 for v in m._state.values() if isinstance(v, torch.Tensor))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    m.half()
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_to_device_moves_the_network():
    m = _quiet(lambda: port.LPIPS(device="cpu"))
    m.to("meta")
    assert m.device.type == "meta"
    assert {p.device.type for p in _network(m).parameters()} == {"meta"}
    assert m.sum_scores.device.type == "meta"


def test_strict_load_of_the_reference_states():
    from metrics_tpu_torch.utils.convert import state_dict_from_reference

    m_ref = _feed_fid(ref.FID(feature=_identity, feature_dim=D, streaming=True), jnp.asarray)
    m = port.FID(feature=_identity, feature_dim=D, streaming=True, device="cpu")
    m.load_state_dict(state_dict_from_reference({k: np.asarray(v) for k, v in m_ref._state.items()}, device="cpu"),
                      strict=True)
    _close(m.compute(), m_ref.compute(), 0.0, FID_RTOL)


def _manifest_states(path):
    blob = open(path, "rb").read()
    hlen, _ = struct.unpack_from("<QI", blob, 8)
    manifest = json.loads(blob[20: 20 + hlen])
    return sorted(manifest["metrics"]["__metric__"]["reductions"]), manifest["payload_nbytes"]


def test_checkpoint_holds_the_states_only(network_metrics, tmp_path):
    m, m_ref = network_metrics["fid"]
    names, nbytes = _manifest_states(save_checkpoint(m, str(tmp_path), rank=0, world=1))
    assert names == sorted(m_ref._state)
    assert nbytes < 200_000  # 4 x [64, 64] + 4 x [64] + 2 float32, not 24M weights


@pytest.fixture
def world(monkeypatch):
    clear_sync_plan_cache()
    yield TorchLockstepWorld(2).install(monkeypatch)
    clear_sync_plan_cache()


def test_sync_payload_holds_the_states_only(world):
    imgs = _t(np.random.RandomState(2).randint(0, 256, (2, 2, 3, 32, 32)).astype(np.uint8))

    def body(rank):
        m = _quiet(lambda: port.FID(feature=64, streaming=True, device="cpu"))
        m.update(imgs[rank], real=True)
        m.update(imgs[1 - rank], real=False)
        m.sync()
        synced = sorted(m._state)
        n = float(m.real_n)
        m.unsync()
        return synced, n

    for synced, n in world.run(body):
        assert synced == sorted(_network_metrics()["fid"][1]()._state) and n == 4.0
    assert world.bytes < 1_000_000


# ---------------------------------------------------------------------------
# JAX checkpoints load into the port
# ---------------------------------------------------------------------------

def _ssim_batches(m, to):
    rng = np.random.RandomState(31)
    for _ in range(2):
        p = rng.rand(2, 3, 20, 20).astype(np.float32)
        m.update(to(p), to(np.clip(p + rng.randn(2, 3, 20, 20).astype(np.float32) * 0.1, 0, 1)))
    return m


JAX_FILES = {
    "ssim": (lambda: ref.SSIM(data_range=1.0), lambda: port.SSIM(data_range=1.0, device="cpu"), _ssim_batches, 0.0),
    "psnr": (lambda: ref.PSNR(), lambda: port.PSNR(device="cpu"),
             lambda m, to: [m.update(to(PSNR_INPUTS[1][0][b]), to(PSNR_INPUTS[1][1][b])) for b in range(2)] and m,
             PSNR_ATOL),
    "fid_streaming": (lambda: ref.FID(feature=_identity, feature_dim=D, streaming=True),
                      lambda: port.FID(feature=_identity, feature_dim=D, streaming=True, device="cpu"),
                      _feed_fid, None),
}


@pytest.mark.parametrize("name", list(JAX_FILES))
def test_jax_checkpoint_loads_into_the_port(name, tmp_path):
    make_ref, make_port, feed, atol = JAX_FILES[name]
    m_ref = feed(make_ref(), jnp.asarray)
    ref.save_checkpoint(m_ref, str(tmp_path), rank=0, world=1)
    m = load_checkpoint(make_port(), str(tmp_path), rank=0, world=1)
    for k, v in m_ref._state.items():
        got = getattr(m, k)
        assert got.dtype == torch.float32 and np.array_equal(_np(got), _np(v)), k
    if atol is None:
        _close(m.compute(), m_ref.compute(), 0.0, FID_RTOL)
    else:
        _close(m.compute(), m_ref.compute(), atol)


# ---------------------------------------------------------------------------
# two ranks, and their shards folded 2 -> 1
# ---------------------------------------------------------------------------

def _rank_batches(rank):
    return range(rank * FEAT_BATCHES // 2, (rank + 1) * FEAT_BATCHES // 2)


def _fid(streaming):
    return port.FID(feature=_identity, feature_dim=D, streaming=streaming, device="cpu")


@pytest.mark.parametrize("streaming", [True, False], ids=["kahan_states", "feature_lists"])
def test_fid_two_rank_sync_and_fold_equal_one_process(world, streaming, tmp_path):
    def body(rank):
        m = _feed_fid(_fid(streaming), _t, _rank_batches(rank))
        # an explicit step: ranks on threads save at once, and with step=None
        # a rank that looks while its peer's shard is still a temp file
        # starts a step of its own (the two shards then never form one)
        save_checkpoint(m, str(tmp_path), step=0, rank=rank, world=2)
        m.sync()
        synced = {k: [x.clone() for x in v] if isinstance(v, list) else v.clone() for k, v in m._state.items()}
        m.unsync()
        return synced, m.compute()

    results = world.run(body)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("metrics_tpu_torch.parallel.sync.distributed_available", lambda group=None: False)
        one = _feed_fid(_fid(streaming), _t)
        want = one.compute()
        folded = load_checkpoint(_fid(streaming), str(tmp_path), rank=0, world=1)
        folded_value = folded.compute()
    for synced, value in results:
        if streaming:
            for side in ("real", "fake"):
                assert float(synced[f"{side}_n"]) == float(getattr(one, f"{side}_n"))
                for base in ("sum", "outer"):
                    key = f"{side}_{base}"
                    _close(synced[key] - synced[f"{key}_comp"], getattr(one, key) - getattr(one, f"{key}_comp"),
                           0.0, 1e-6)
            _close(value, want, 0.0, FID_RTOL)
        else:  # the gathered rows are one process's rows, in rank order
            for side in ("real", "fake"):
                rows = torch.cat(synced[f"{side}_features"])
                assert torch.equal(rows, torch.cat(getattr(one, f"{side}_features")))
            assert torch.equal(value, want)
    # the fold goes through FID.merge_states (the Kahan merge when streaming)
    _close(folded_value, want, 0.0, FID_RTOL)
    if not streaming:
        assert torch.equal(torch.cat(folded.real_features), torch.cat(one.real_features))
