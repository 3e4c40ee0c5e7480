"""``metrics_tpu_torch/ops/prng.py`` against ``jax.random``, bit for bit.

KID and IS draw their subsets and their shuffle with ``jax.random`` in the
JAX package; the port's draws must be the same integers for the same seed,
or KID and IS differ. Every comparison here is exact: keys, split keys and
permutations are integers. The sizes cover one shuffle round (n ≤ 1625),
two rounds (n > 1625) and n past 2**16, and a batch of keys (JAX's ``vmap``).

BootStrapper's draws: ``uniform`` and ``randint`` bit for bit (spans below,
at and above 2**16, where JAX's multiplier wraps to 0, and the full int32
range), and ``poisson`` at λ ∈ {0.5, 1, 4} equal draw for draw. A Poisson
count may differ only where the running sum of ``log`` lies within a few
ulps of ``-λ`` (torch's ``log`` and XLA's may round differently): every
differing draw must be such a near-tie, its sum recomputed in float64.
"""
import jax
import numpy as np
import pytest
import torch

import metrics_tpu as ref
from metrics_tpu_torch.ops import prng

SEEDS = [0, 1, 42, 2**31 - 1, -7]
SIZES = [1, 2, 5, 1000, 1625, 1626, 4097, 70_001]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert np.array_equal(prng.prng_key(seed).numpy(), _np(jax.random.PRNGKey(seed)))


def test_prng_key_refuses_seeds_past_32_bits():
    with pytest.raises(ValueError, match="32 bits"):
        prng.prng_key(2**32)


@pytest.mark.parametrize("num", [2, 3, 100])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, num):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(prng.split(prng.prng_key(seed), num).numpy(), _np(jax.random.split(key, num)))


def test_split_of_a_batch_of_keys_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.stack([_np(jax.random.split(k, 5)) for k in keys])
    assert np.array_equal(prng.split(torch.from_numpy(_np(keys)), 5).numpy(), want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_permutation_matches_jax(seed, n):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = prng.permutation(prng.prng_key(seed), n)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def test_shuffle_rounds_match_jax_heuristic():
    for n in SIZES + [2**21, 2**22]:
        assert prng.shuffle_rounds(n) == int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def test_batched_permutation_matches_vmap():
    keys = jax.random.split(jax.random.PRNGKey(11), 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 3000))(keys))
    assert np.array_equal(prng.permutation(torch.from_numpy(_np(keys)), 3000).numpy(), want)


@pytest.mark.parametrize("n_real, n_fake, subsets, subset_size", [(40, 36, 5, 16), (2000, 1700, 3, 1000)])
def test_kid_subset_draw_matches_the_jax_package(n_real, n_fake, subsets, subset_size):
    """The index matrices of ``metrics_tpu/image/kid.py::KID.compute``."""
    import metrics_tpu_torch as port

    seed = 42
    k_real, k_fake = jax.random.split(jax.random.PRNGKey(seed))
    want_real = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n_real)[:subset_size])(
        jax.random.split(k_real, subsets)))
    want_fake = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n_fake)[:subset_size])(
        jax.random.split(k_fake, subsets)))
    kid = port.KID(feature=lambda x: x, subsets=subsets, subset_size=subset_size, seed=seed, device="cpu")
    got_real, got_fake = kid.subset_indices(n_real, n_fake)
    assert np.array_equal(got_real.numpy(), want_real)
    assert np.array_equal(got_fake.numpy(), want_fake)


@pytest.mark.parametrize("n", [16, 10_000])
def test_is_shuffle_matches_the_jax_package(n):
    """The shuffle of ``metrics_tpu/image/inception.py::IS.compute``."""
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(42), n))
    assert np.array_equal(prng.permutation(prng.prng_key(42), n).numpy(), want)


def test_is_value_depends_on_the_draw():
    """With a feature set whose splits differ, another permutation (a
    ``torch.randperm``) gives another IS: the draw is part of the result."""
    rng = np.random.RandomState(5)
    logits = rng.randn(24, 6).astype(np.float32) * 3
    m = ref.IS(feature=lambda x: x, splits=4)
    m.update(jax.numpy.asarray(logits))
    want = np.asarray(m.compute()[1])
    import metrics_tpu_torch as port

    p = port.IS(feature=lambda x: x, splits=4, device="cpu")
    p.update(torch.from_numpy(logits))
    np.testing.assert_allclose(p.compute()[1].numpy(), want, rtol=1e-5, atol=1e-6)
    other = port.IS(feature=lambda x: x, splits=4, seed=43, device="cpu")
    other.update(torch.from_numpy(logits))
    assert abs(float(other.compute()[1]) - float(want)) > 1e-4


def _keys(seed, n):
    """``n`` subkeys, each from one ``key, subkey = split(key)``, as
    BootStrapper takes them: JAX's and the port's."""
    key, tkey, subs, tsubs = jax.random.PRNGKey(seed), prng.prng_key(seed), [], []
    for _ in range(n):
        key, sub = jax.random.split(key)
        keys = prng.split(tkey)
        tkey = keys[0]
        subs.append(sub)
        tsubs.append(keys[1])
    return subs, torch.stack(tsubs)


@pytest.mark.parametrize("seed", [0, 42, -7])
def test_uniform_matches_jax_bit_for_bit(seed):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (4097,)))
    got = prng.uniform(prng.prng_key(seed), 4097)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("bounds", [(0, 2000), (0, 7), (-5, 1000), (3, 3), (0, 65536), (0, 65537), (0, 100_000),
                                    (-(2**31), 2**31 - 1)])
@pytest.mark.parametrize("seed", [0, 42])
def test_randint_matches_jax_bit_for_bit(seed, bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (3000,), lo, hi))
    assert np.array_equal(prng.randint(prng.prng_key(seed), 3000, lo, hi).numpy(), want)


def test_randint_of_a_batch_of_keys_matches_jax():
    subs, tsubs = _keys(5, 6)
    want = np.stack([np.asarray(jax.random.randint(k, (500,), 0, 500)) for k in subs])
    assert np.array_equal(prng.randint(tsubs, 500, 0, 500).numpy(), want)


def _near_tie(subkey, lam, draws):
    """Is the Knuth loop of one draw a near-tie: does some running sum of
    ``log(u)``, recomputed in float64 from the same uniforms, lie within a
    few float32 ulps of ``-lam``? ``draws`` bounds the iterations."""
    rng, total = subkey, 0.0
    for _ in range(draws + 2):
        keys = prng.split(rng)
        rng = keys[0]
        u = prng.uniform(keys[1], 1).double()
        if abs(total + lam) <= 8 * np.finfo(np.float32).eps * max(1.0, lam):
            return True
        total += float(torch.log(u))
    return False


@pytest.mark.parametrize("lam", [0.5, 1.0, 4.0])
def test_poisson_matches_jax(lam):
    subs, tsubs = _keys(3, 4)
    want = np.stack([np.asarray(jax.random.poisson(k, lam, (5000,))) for k in subs])
    reads = prng.HOST_READS["poisson"]
    got = prng.poisson(tsubs, lam, 5000)
    assert got.dtype == torch.int64 and got.shape == (4, 5000)
    # one host read per iteration of the loop: the most draws, plus the last check
    assert prng.HOST_READS["poisson"] - reads == int(got.max()) + 2
    differ = np.argwhere(got.numpy() != want)
    explained = [(b, i) for b, i in differ if _near_tie(tsubs[b], lam, int(max(got[b, i], want[b, i])))]
    assert len(explained) == len(differ), f"draws that differ and are no near-tie: {differ.tolist()}"
    assert len(differ) <= 2, f"{len(differ)} near-ties in 20000 draws"


def test_poisson_of_one_key_and_zero_rate():
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.poisson(key, 1.0, (300,)))
    assert np.array_equal(prng.poisson(prng.prng_key(9), 1.0, 300).numpy(), want)
    assert int(prng.poisson(prng.prng_key(9), 0.0, 300).abs().sum()) == 0
    with pytest.raises(ValueError, match="lam < 10"):
        prng.poisson(prng.prng_key(9), 12.0, 10)
