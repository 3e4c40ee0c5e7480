"""The port's audio family against the JAX package, on the CPU.

SNR, SI-SDR, SI-SNR and PIT, functionals and modules, fed the same seeded
numpy signals in both packages.

Tolerances. A value is ``10 * log10(ratio)`` of two float32 sums over
``T`` samples, summed in another order by each package: each sum may move
by ~``log2(T) * 2**-24`` of itself, the ratio by twice that and the dB
value by ``10 / ln(10)`` times the ratio's relative error. With ``T = 256``
that is 4.3 * 2 * 8 * 2**-24 = 4.1e-6 dB; SI-SDR scales the target by
``alpha`` first (one more sum), so ``DB_ATOL = 1e-5`` dB holds all three
with room. Module sums add up to 12 such values: ``SUM_ATOL = 1e-4``.
Counts are exact.

PIT near-ties (the exhaustive search takes the first best permutation):
where two permutations' mean scores lie within ``DB_ATOL`` of each other,
the packages may pick different ones. The best values are held equal
everywhere; the permutations only where the margin between the best and
the second best permutation (computed here in float64) exceeds
``2 * DB_ATOL``. The data is random noise, not chosen to avoid ties.
"""
from itertools import permutations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional.audio as ref_fn
import metrics_tpu_torch as port
import metrics_tpu_torch.functional.audio as port_fn
from metrics_tpu_torch.functional.audio.pit import _best_perm_hungarian, _metric_matrix

DB_ATOL, SUM_ATOL = 1e-5, 1e-4
T = 256
# si_snr is si_sdr with zero_mean=True and takes no zero_mean argument
FUNC_CASES = [("snr", False), ("snr", True), ("si_sdr", False), ("si_sdr", True), ("si_snr", None)]


def _signals(shape, seed):
    rng = np.random.RandomState(seed)
    target = rng.randn(*shape).astype(np.float32)
    preds = (target + 0.5 * rng.randn(*shape)).astype(np.float32)
    return preds, target


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name,zero_mean", FUNC_CASES)
def test_functional_matches_reference(name, zero_mean):
    kw = {} if zero_mean is None else {"zero_mean": zero_mean}
    preds, target = _signals((4, 2, T), 0)
    want = getattr(ref_fn, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
    got = getattr(port_fn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    assert got.shape == (4, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=DB_ATOL, rtol=0)


def test_eps_is_the_inputs_machine_epsilon():
    """Silent signals: the ratio is eps / eps, 0 dB, with eps of the input's
    dtype (float64 here), in both packages."""
    zeros = np.zeros((2, 8))
    for name in ("snr", "si_sdr"):
        got = getattr(port_fn, name)(torch.from_numpy(zeros), torch.from_numpy(zeros))
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(_np(got), 0.0)


MODULES = {
    "SNR": (lambda pkg, **kw: pkg.SNR(**kw), "sum_snr"),
    "SNR_zero_mean": (lambda pkg, **kw: pkg.SNR(zero_mean=True, **kw), "sum_snr"),
    "SI_SDR": (lambda pkg, **kw: pkg.SI_SDR(**kw), "sum_si_sdr"),
    "SI_SNR": (lambda pkg, **kw: pkg.SI_SNR(**kw), "sum_si_snr"),
    "PIT": (lambda pkg, **kw: pkg.PIT((ref_fn if pkg is ref else port_fn).si_sdr, "max", **kw), "sum_pit_metric"),
    "PIT_min": (lambda pkg, **kw: pkg.PIT((ref_fn if pkg is ref else port_fn).snr, "min", **kw), "sum_pit_metric"),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_reference(name):
    make, sum_state = MODULES[name]
    jm, pm = make(ref), make(port, device="cpu")
    for seed in (1, 2):
        preds, target = _signals((3, 2, T), seed)
        jv = jm(jnp.asarray(preds), jnp.asarray(target))
        pv = pm(torch.from_numpy(preds), torch.from_numpy(target))
        np.testing.assert_allclose(_np(pv), np.asarray(jv), atol=DB_ATOL, rtol=0)
    assert pm.total.dtype == torch.int64 and int(pm.total) == int(jm.total)
    assert getattr(pm, sum_state).dtype == torch.float32
    np.testing.assert_allclose(_np(getattr(pm, sum_state)), np.asarray(getattr(jm, sum_state)), atol=SUM_ATOL)
    np.testing.assert_allclose(_np(pm.compute()), np.asarray(jm.compute()), atol=DB_ATOL, rtol=0)


def _margins(preds, target, maximize):
    """Per sample: the gap between the best and the second best mean
    score over every permutation, in float64."""
    spk = target.shape[1]
    p, t = preds.astype(np.float64), target.astype(np.float64)
    alpha = (np.einsum("bet,bst->bse", p, t)) / np.einsum("bst,bst->bs", t, t)[:, :, None]
    # si_sdr of estimate e against target s
    scaled = alpha[..., None] * t[:, :, None, :]
    noise = scaled - p[:, None, :, :]
    mtx = 10 * np.log10(np.sum(scaled ** 2, -1) / np.sum(noise ** 2, -1))
    scores = np.stack([mtx[:, np.arange(spk), list(perm)].mean(-1) for perm in permutations(range(spk))], -1)
    scores = np.sort(scores, -1)
    return scores[:, -1] - scores[:, -2] if maximize else scores[:, 1] - scores[:, 0]


@pytest.mark.parametrize("spk", [2, 3, 7])
@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_matches_reference(spk, eval_func):
    """2 and 3 speakers take the exhaustive search, 7 the host Hungarian
    solve: equal best values everywhere, equal permutations wherever the
    margin exceeds the tolerance (see the module docstring)."""
    rng = np.random.RandomState(10 + spk)
    target = rng.randn(4, spk, 64).astype(np.float32)
    preds = (target[:, rng.permutation(spk)] + 0.8 * rng.randn(4, spk, 64)).astype(np.float32)
    want_metric, want_perm = ref_fn.pit(jnp.asarray(preds), jnp.asarray(target), ref_fn.si_sdr, eval_func)
    got_metric, got_perm = port_fn.pit(torch.from_numpy(preds), torch.from_numpy(target), port_fn.si_sdr, eval_func)
    assert got_perm.dtype == torch.int64 and got_perm.shape == (4, spk)
    np.testing.assert_allclose(_np(got_metric), np.asarray(want_metric), atol=DB_ATOL, rtol=0)
    clear = _margins(preds, target, eval_func == "max") > 2 * DB_ATOL
    assert clear.any()
    np.testing.assert_array_equal(_np(got_perm)[clear], np.asarray(want_perm)[clear])
    permuted = port_fn.pit_permutate(torch.from_numpy(preds), got_perm)
    np.testing.assert_array_equal(
        _np(permuted), np.asarray(ref_fn.pit_permutate(jnp.asarray(preds), jnp.asarray(_np(got_perm)))))


def test_pit_exhaustive_and_hungarian_agree():
    preds, target = _signals((3, 4, T), 5)
    exhaustive = port_fn.pit(torch.from_numpy(preds), torch.from_numpy(target), port_fn.si_sdr)
    mtx = _metric_matrix(torch.from_numpy(preds), torch.from_numpy(target), port_fn.si_sdr)
    hungarian = _best_perm_hungarian(mtx, True)
    np.testing.assert_allclose(_np(exhaustive[0]), _np(hungarian[0]), atol=DB_ATOL, rtol=0)
    np.testing.assert_array_equal(_np(exhaustive[1]), _np(hungarian[1]))


def test_pit_permutate_inverts_a_permutation():
    preds = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    perm = torch.tensor([[2, 0, 1], [1, 2, 0]])
    out = port_fn.pit_permutate(preds, perm)
    for b in range(2):
        for s in range(3):
            assert torch.equal(out[b, s], preds[b, perm[b, s]])


@pytest.mark.parametrize("case", ["shape", "eval_func", "ndim"])
def test_errors_match_reference(case):
    a = np.zeros((2, 2, 8), np.float32)
    args = {
        "shape": (a, a[:, :1], "max"),
        "eval_func": (a, a, "mean"),
        "ndim": (a[0, 0], a[0, 0], "max"),
    }[case]
    with pytest.raises(Exception) as want:
        ref_fn.pit(jnp.asarray(args[0]), jnp.asarray(args[1]), ref_fn.si_sdr, args[2])
    with pytest.raises(want.type):
        port_fn.pit(torch.from_numpy(args[0]), torch.from_numpy(args[1]), port_fn.si_sdr, args[2])
    if case == "shape":
        with pytest.raises(want.type):
            port_fn.snr(torch.from_numpy(args[0]), torch.from_numpy(args[1]))
