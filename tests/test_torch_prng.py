"""``metrics_tpu_torch/ops/prng.py`` against ``jax.random``, bit for bit.

KID and IS draw their subsets and their shuffle with ``jax.random`` in the
JAX package; the port's draws must be the same integers for the same seed,
or KID and IS differ. Every comparison here is exact: keys, split keys and
permutations are integers. The sizes cover one shuffle round (n ≤ 1625),
two rounds (n > 1625) and n past 2**16, and a batch of keys (JAX's ``vmap``).
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
