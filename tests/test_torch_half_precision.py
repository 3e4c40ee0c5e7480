"""Half-precision inputs: the port against the JAX package in bfloat16 and
float16 (ROADMAP C.18).

Port twin of ``tests/bases/test_dtype_and_grad.py::test_half_precision`` and
``tests/bases/test_registry_sweep.py::test_bf16``. Each case feeds the same
numpy inputs, cast to the half dtype, to both packages, and holds the port's
value to the JAX package's: the same dtype, within two ulps of that dtype for
a half-precision value and within 1e-5 (float32 sums in another order) for a
float32 one; counts by value (the port counts in int64, the JAX package in
int32: C.9). Each value also stays near the float32 run, as the JAX tests
ask. Then the weakly typed states: Hinge's ``measure`` and KLDivergence's
``measures`` take the first input's half dtype, as the JAX package's
``jnp.asarray(0.0)`` does, through ``forward`` too; ``set_dtype`` overrides
it; a JAX-written checkpoint with a bfloat16 ``measures`` loads as one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port

NUM_BATCHES, BATCH_SIZE, NUM_CLASSES = 2, 32, 5
rng = np.random.RandomState(11)
_float_preds = rng.randn(NUM_BATCHES, BATCH_SIZE).astype(np.float32)
_float_target = rng.randn(NUM_BATCHES, BATCH_SIZE).astype(np.float32)
_pos_preds = np.abs(_float_preds) + 0.1
_pos_target = np.abs(_float_target) + 0.1
_prob_preds = rng.rand(NUM_BATCHES, BATCH_SIZE, NUM_CLASSES).astype(np.float32)
_class_target = rng.randint(0, NUM_CLASSES, (NUM_BATCHES, BATCH_SIZE))
_bin_preds = rng.rand(NUM_BATCHES, BATCH_SIZE).astype(np.float32)
_bin_target = rng.randint(0, 2, (NUM_BATCHES, BATCH_SIZE))
_2d_preds = rng.randn(NUM_BATCHES, BATCH_SIZE, 8).astype(np.float32)
_2d_target = rng.randn(NUM_BATCHES, BATCH_SIZE, 8).astype(np.float32)
_probdist = rng.rand(NUM_BATCHES, BATCH_SIZE, NUM_CLASSES).astype(np.float32) + 0.05
_probdist /= _probdist.sum(-1, keepdims=True)
_probdist2 = rng.rand(NUM_BATCHES, BATCH_SIZE, NUM_CLASSES).astype(np.float32) + 0.05
_probdist2 /= _probdist2.sum(-1, keepdims=True)
_hinge_target = rng.randint(0, 2, (NUM_BATCHES, BATCH_SIZE))

# (id, class name, preds, target, args, atol against float32) — the JAX
# test's cases and tolerances, with Hinge (the other weakly typed state)
CASES = [
    ("mse", "MeanSquaredError", _float_preds, _float_target, {}, 0.05),
    ("mae", "MeanAbsoluteError", _float_preds, _float_target, {}, 0.02),
    ("msle", "MeanSquaredLogError", _pos_preds, _pos_target, {}, 0.05),
    ("mape", "MeanAbsolutePercentageError", _pos_preds, _pos_target, {}, 0.02),
    ("smape", "SymmetricMeanAbsolutePercentageError", _pos_preds, _pos_target, {}, 0.02),
    ("r2", "R2Score", _float_preds, _float_target, {}, 0.05),
    ("pearson", "PearsonCorrcoef", _float_preds, _float_target, {}, 0.02),
    ("explained_variance", "ExplainedVariance", _float_preds, _float_target, {}, 0.05),
    ("tweedie", "TweedieDevianceScore", _pos_preds, _pos_target, {}, 0.05),
    ("cosine", "CosineSimilarity", _2d_preds, _2d_target, {}, 0.02),
    ("snr", "SNR", _float_preds, _float_target, {}, 0.02),
    ("si_snr", "SI_SNR", _float_preds, _float_target, {}, 0.02),
    ("si_sdr", "SI_SDR", _float_preds, _float_target, {}, 0.02),
    ("kl", "KLDivergence", _probdist, _probdist2, {}, 0.02),
    ("hinge", "Hinge", _float_preds, _hinge_target, {}, 0.02),
    ("accuracy", "Accuracy", _prob_preds, _class_target, {"num_classes": NUM_CLASSES}, 0.02),
    ("auroc", "AUROC", _bin_preds, _bin_target, {}, 0.02),
    ("confmat", "ConfusionMatrix", _prob_preds, _class_target, {"num_classes": NUM_CLASSES}, 4.0),
]

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
_TORCH_OF = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
             "int32": torch.int32, "int64": torch.int64}


def _run(pkg, name, args, preds, target, dtype, method="update"):
    kw = {} if pkg is ref else {"device": "cpu"}
    m = getattr(pkg, name)(**args, **kw)
    out = None
    for i in range(NUM_BATCHES):
        if pkg is ref:
            p, t = jnp.asarray(preds[i]), jnp.asarray(target[i])
            p = p.astype(dtype) if jnp.issubdtype(p.dtype, jnp.floating) else p
            t = t.astype(dtype) if jnp.issubdtype(t.dtype, jnp.floating) else t
        else:
            p, t = torch.from_numpy(np.asarray(preds[i])), torch.from_numpy(np.asarray(target[i]))
            p = p.to(dtype) if p.is_floating_point() else p
            t = t.to(dtype) if t.is_floating_point() else t
        out = getattr(m, method)(p, t) if method == "forward" else m.update(p, t)
    return m, m.compute(), out


def _as_torch(v):
    arr = np.asarray(jnp.asarray(v, jnp.float32))
    return torch.from_numpy(arr), _TORCH_OF[str(jnp.asarray(v).dtype)]


#: Cases whose half-precision values differ from the JAX package's by a
#: rounding, not by a dtype: XLA fuses the elementwise chain of a signal
#: ratio (SNR, SI-SNR, SI-SDR: a log10 of a ratio of sums) and rounds it to
#: bfloat16 once, where torch rounds after every op; MSLE's float16 sum of
#: log1p squares rounds in another order (one float16 ulp, ROADMAP C.18).
#: Held to two ulps of the half dtype, on the value's scale.
HALF_ROUNDING = {("snr", "bf16"), ("si_snr", "bf16"), ("si_sdr", "bf16"), ("msle", "f16")}


def _assert_like_jax(got, want, what, half_ulps=None):
    want_t, want_dtype = _as_torch(want)
    if want_dtype in (torch.int32, torch.int64):
        assert not got.is_floating_point() and torch.equal(got.to(torch.int64), want_t.to(torch.int64)), what
        return
    assert got.dtype == want_dtype, f"{what}: dtype {got.dtype}, JAX {want_dtype}"
    got_f = got.to(torch.float32)
    if half_ulps is not None:
        eps = torch.finfo(half_ulps).eps
        torch.testing.assert_close(got_f, want_t, rtol=2 * eps, atol=2 * eps * float(want_t.abs().max()), msg=what)
    elif want_dtype == torch.float32:
        torch.testing.assert_close(got_f, want_t, rtol=1e-5, atol=1e-6, msg=what)
    else:
        ulp = torch.finfo(want_dtype).eps
        torch.testing.assert_close(got_f, want_t, rtol=2 * ulp, atol=2 * ulp * float(want_t.abs().max()), msg=what)


@pytest.mark.parametrize("half", sorted(DTYPES))
@pytest.mark.parametrize("name,cls,preds,target,args,atol", CASES, ids=[c[0] for c in CASES])
def test_half_precision_matches_the_jax_package(name, cls, preds, target, args, atol, half):
    torch_dtype, jax_dtype = DTYPES[half]
    _, got, _ = _run(port, cls, args, preds, target, torch_dtype)
    _, want, _ = _run(ref, cls, args, preds, target, jax_dtype)
    _assert_like_jax(got, want, f"{name} {half}", torch_dtype if (name, half) in HALF_ROUNDING else None)
    _, full, _ = _run(port, cls, args, preds, target, torch.float32)
    assert torch.isfinite(got.to(torch.float32)).all()
    np.testing.assert_allclose(got.to(torch.float64).numpy(), full.to(torch.float64).numpy(), atol=atol, rtol=5e-2)


@pytest.mark.parametrize("half", sorted(DTYPES))
@pytest.mark.parametrize("cls,state,preds,target", [
    ("Hinge", "measure", _float_preds, _hinge_target),
    ("KLDivergence", "measures", _probdist, _probdist2),
])
def test_weak_state_takes_the_input_dtype(cls, state, preds, target, half):
    torch_dtype, jax_dtype = DTYPES[half]
    for method in ("update", "forward"):
        m, got, batch = _run(port, cls, {}, preds, target, torch_dtype, method)
        r, want, ref_batch = _run(ref, cls, {}, preds, target, jax_dtype, method)
        assert getattr(m, state).dtype == torch_dtype == _as_torch(getattr(r, state))[1]
        _assert_like_jax(got, want, f"{cls} {method}")
        if method == "forward":
            _assert_like_jax(batch, ref_batch, f"{cls} batch value")
    # a float32 batch after a half one: the state is fixed, float32 promotes
    m.update(torch.from_numpy(preds[0]), torch.from_numpy(target[0]))
    r.update(jnp.asarray(preds[0]), jnp.asarray(target[0]))
    assert getattr(m, state).dtype == _as_torch(getattr(r, state))[1]
    _assert_like_jax(m.compute(), r.compute(), f"{cls} mixed")
    m.reset()
    t0 = torch.from_numpy(target[0])
    m.update(torch.from_numpy(preds[0]).to(torch_dtype), t0.to(torch_dtype) if t0.is_floating_point() else t0)
    assert getattr(m, state).dtype == torch_dtype, "reset makes the state weak again"


def test_set_dtype_overrides_the_weak_dtype():
    m = port.KLDivergence(device="cpu").set_dtype(torch.float16)
    r = ref.KLDivergence().set_dtype(jnp.float16)
    for i in range(NUM_BATCHES):
        m.update(torch.from_numpy(_probdist[i]).to(torch.bfloat16), torch.from_numpy(_probdist2[i]).to(torch.bfloat16))
        r.update(jnp.asarray(_probdist[i], jnp.bfloat16), jnp.asarray(_probdist2[i], jnp.bfloat16))
    assert m.measures.dtype == torch.float16 == _as_torch(r.measures)[1]
    _assert_like_jax(m.compute(), r.compute(), "kl set_dtype(float16)")


def test_jax_checkpoint_with_a_bfloat16_measures_loads(tmp_path):
    r = ref.KLDivergence()
    r.update(jnp.asarray(_probdist[0], jnp.bfloat16), jnp.asarray(_probdist2[0], jnp.bfloat16))
    ref.save_checkpoint(r, str(tmp_path))
    m = port.KLDivergence(device="cpu")
    port.load_checkpoint(m, str(tmp_path))
    assert m.measures.dtype == torch.bfloat16
    for pkg_m, conv in ((m, lambda x: torch.from_numpy(x)), (r, jnp.asarray)):
        pkg_m.update(conv(_probdist[1]), conv(_probdist2[1]))  # float32: the loaded bfloat16 is strong
    assert m.measures.dtype == _as_torch(r.measures)[1] == torch.float32
    _assert_like_jax(m.compute(), r.compute(), "kl resumed")
