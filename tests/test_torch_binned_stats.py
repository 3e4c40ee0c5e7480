"""The port's binned-counts op (metrics_tpu_torch/ops/binned_stats.py) against
the JAX package's (metrics_tpu/ops/pallas_binned.py).

Both plain forms must equal the JAX compare oracle bit for bit (the counts are
integers held in float32), ties at a threshold and NaN preds included. The
CUDA kernel is held against the compare form on the card only. JAX is
imported inside the tests that use it, so that the card's cases also run
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_binned_stats.py
"""
import numpy as np
import pytest
import torch

from metrics_tpu_torch.ops import binned_stats
from metrics_tpu_torch.utils.data import _linspace_like_reference

# the shapes of tests/ops/test_pallas_binned.py
SHAPES = [(37, 3, 100), (256, 10, 5), (5, 1, 1), (1000, 17, 130), (64, 130, 20)]
FORMS = {"compare": binned_stats._binned_stats_compare, "bucket": binned_stats._binned_stats_bucket}


def _data(n, c, t, seed=42, plant_ties=True, plant_nan=False):
    rng = np.random.RandomState(seed)
    thresholds = np.linspace(0, 1, t).astype(np.float32)
    preds = rng.rand(n, c).astype(np.float32)
    if plant_ties and n > 4:
        # exact-threshold values: ties must classify identically everywhere
        k = min(n // 4, t)
        preds[:k] = thresholds[rng.randint(0, t, (k, c))]
    if plant_nan:
        preds[rng.rand(n, c) < 0.1] = np.nan
    target = (rng.rand(n, c) > 0.5).astype(np.float32)
    return preds, target, thresholds


def _jax_oracle(preds, target, thresholds):
    import jax.numpy as jnp
    from metrics_tpu.ops.pallas_binned import _binned_stats_xla

    return [np.asarray(x) for x in _binned_stats_xla(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds))]


def _assert_equal(got, want):
    for g, w, name in zip(got, want, ("tp", "fp", "fn")):
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("n,c,t", SHAPES)
def test_plain_forms_bit_exact_vs_jax_oracle(form, n, c, t):
    preds, target, thresholds = _data(n, c, t)
    got = FORMS[form](torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    _assert_equal(got, _jax_oracle(preds, target, thresholds))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_nan_preds_are_negative_everywhere(form):
    preds, target, thresholds = _data(300, 4, 33, plant_nan=True)
    assert np.isnan(preds).any()
    got = FORMS[form](torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    _assert_equal(got, _jax_oracle(preds, target, thresholds))


def test_threshold_boundary_semantics():
    # a pred exactly at a threshold is a positive prediction (>=), in every form
    preds = torch.tensor([[0.0], [0.5], [1.0]])
    target = torch.tensor([[1.0], [0.0], [1.0]])
    thresholds = torch.tensor([0.0, 0.5, 1.0])
    for fn in (*FORMS.values(), binned_stats.binned_stat_scores):
        tp, fp, fn_ = fn(preds, target, thresholds)
        assert tp.tolist() == [[2.0, 1.0, 1.0]], fn
        assert fp.tolist() == [[1.0, 1.0, 0.0]], fn
        assert fn_.tolist() == [[0.0, 1.0, 1.0]], fn


def _forbid_bucket(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("the bucket form needs ascending thresholds and must not run here")

    monkeypatch.setattr(binned_stats, "_binned_stats_bucket", boom)


def _spy_bucket(monkeypatch):
    called = []
    real = binned_stats._binned_stats_bucket
    monkeypatch.setattr(binned_stats, "_binned_stats_bucket", lambda *a: called.append(1) or real(*a))
    return called


def test_unsorted_thresholds_take_the_bucket_form(monkeypatch):
    # the bucket form sorts the thresholds itself: no sortedness check on the host
    preds, target, thresholds = _data(200, 3, 40)
    thresholds = np.random.RandomState(1).permutation(thresholds)
    called = _spy_bucket(monkeypatch)
    got = binned_stats.binned_stat_scores(
        torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds)
    )
    assert called == [1]
    _assert_equal(got, _jax_oracle(preds, target, thresholds))


def _scrambled_thresholds(t, seed):
    """The ascending grid permuted, with a duplicate and two NaNs planted."""
    rng = np.random.RandomState(seed)
    thresholds = rng.permutation(np.linspace(0, 1, t).astype(np.float32))
    return np.concatenate([thresholds, thresholds[:1], np.array([np.nan, np.nan], np.float32)])[rng.permutation(t + 3)]


@pytest.mark.parametrize("n,c,t", SHAPES)
def test_permuted_bucket_form_bit_exact_vs_jax_oracle(n, c, t):
    preds, target, _ = _data(n, c, t)
    thresholds = _scrambled_thresholds(t, seed=n)
    assert np.isnan(thresholds).sum() == 2
    got = binned_stats._binned_stats_bucket(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    _assert_equal(got, _jax_oracle(preds, target, thresholds))


# (N, C, T) -> (design, class tile, rows per block) on a card with 132 SMs and
# 227 KB of opt-in shared memory per block: an H100 SXM
H100 = dict(smem_limit=binned_stats._SMEM_OPTIN, sm_count=132)
PLANS = {
    # the main path's binned update: a block per class, no merge
    (2048, 10, 100): ("histogram", 1, 2048),
    # the JAX package's binned benchmark: whole rows, 127 row blocks
    (65536, 8, 128): ("histogram", 8, 517),
    # an ImageNet-1k eval batch: 125 tiles of 8 classes, no merge
    (2048, 1000, 100): ("histogram", 8, 2048),
    # tables above 48 KB of shared memory
    (256, 4, 5000): ("histogram", 4, 256),
    # thresholds too many for the histogram's tables
    (64, 3, 16000): ("compare", 32, 32),
}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_plan_is_a_function_of_the_shapes(shape):
    n, c, t = shape
    design, tile, rows = binned_stats._plan(n, c, t, **H100)
    assert (design, tile, rows) == PLANS[shape]
    if design == "histogram":
        assert binned_stats._hist_smem_bytes(t, tile) <= H100["smem_limit"] - binned_stats._SMEM_RESERVE
        one_row_block = rows >= n
        assert (binned_stats._scratch_bytes(design, n, c, t, tile, rows) == 0) == one_row_block


def test_plan_forcing_a_design():
    assert binned_stats._plan(2048, 10, 100, design="compare", **H100)[0] == "compare"
    with pytest.raises(ValueError, match="shared memory"):
        binned_stats._plan(64, 3, 16000, design="histogram", **H100)
    with pytest.raises(ValueError, match="unknown design"):
        binned_stats._plan(64, 3, 100, design="bitonic", **H100)


def test_ascending_thresholds_take_the_bucket_form_on_cpu(monkeypatch):
    preds, target, thresholds = _data(64, 2, 9)
    called = _spy_bucket(monkeypatch)
    binned_stats.binned_stat_scores(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    assert called == [1]


def test_use_kernel_false_forces_the_compare_form(monkeypatch):
    preds, target, thresholds = _data(64, 2, 9)
    _forbid_bucket(monkeypatch)
    got = binned_stats.binned_stat_scores(
        torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds), use_kernel=False
    )
    _assert_equal(got, _jax_oracle(preds, target, thresholds))


def test_use_kernel_true_raises_on_a_cpu_tensor():
    preds, target, thresholds = (torch.from_numpy(a) for a in _data(16, 2, 4))
    launches = binned_stats.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        binned_stats.binned_stat_scores(preds, target, thresholds, use_kernel=True)
    assert binned_stats.KERNEL_LAUNCHES == launches


def test_kernel_wrapper_refuses_cpu_tensors():
    preds, target, thresholds = (torch.from_numpy(a) for a in _data(16, 2, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        binned_stats._binned_stats_kernel(preds, target, thresholds)


def test_jax_pallas_interpret_agrees_with_the_port():
    # the TPU kernel itself, run by the pallas interpreter, at one small shape
    import jax.numpy as jnp
    from metrics_tpu.ops.pallas_binned import binned_stat_scores as jax_binned_stat_scores

    preds, target, thresholds = _data(37, 3, 100, plant_ties=False)
    want = [np.asarray(x) for x in jax_binned_stat_scores(
        jnp.asarray(preds), jnp.asarray(target), jnp.asarray(thresholds), interpret=True
    )]
    got = binned_stats.binned_stat_scores(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thresholds))
    _assert_equal(got, want)


@pytest.mark.parametrize("t", [5, 100, 101, 128])
def test_linspace_like_reference_is_bitwise_jnp_linspace(t):
    import jax.numpy as jnp

    got = _linspace_like_reference(t).numpy()
    want = np.asarray(jnp.linspace(0, 1.0, t))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("design", [None, "compare"])
@pytest.mark.parametrize("thresholds,target_dtype", [("ascending", torch.float32), ("scrambled", torch.int64)])
@pytest.mark.parametrize("n,c,t", SHAPES + [(2048, 10, 100), (300, 1000, 100)])
def test_kernel_matches_compare_form_on_the_card(n, c, t, thresholds, target_dtype, design):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    preds, target, thr = _data(n, c, t, plant_nan=True)
    if thresholds == "scrambled":
        thr = _scrambled_thresholds(t, seed=c)
    preds, target, thr = (torch.from_numpy(a).cuda() for a in (preds, target, thr))
    target = target.to(target_dtype)
    launches = binned_stats.KERNEL_LAUNCHES
    got = binned_stats._binned_stats_kernel(preds, target, thr, design=design)
    want = binned_stats.binned_stat_scores(preds, target, thr, use_kernel=False)
    torch.cuda.synchronize()
    assert binned_stats.KERNEL_LAUNCHES == launches + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
