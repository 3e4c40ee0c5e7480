"""The regression family of the port against the JAX package, on the same
seeded numpy inputs: every functional and module, 1-D and ``[N, D]``
multioutput, integer inputs, the error cases, ``forward``, ``reset``, the
deprecated aliases, and JAX states carried across with
``utils/convert.py::state_dict_from_reference``.

One size serves every case (N = 32 rows, D = 3 outputs, two batches), so
the JAX side compiles each op once per shape; each JAX reference value is
computed once per module (``_ref``).

Tolerances. Counts compare exactly (the port's are int64, the JAX package's
int32: values, not dtypes). A float value compares at ``ATOL = 1e-6`` plus
``RTOL = 2**-20`` of its size: the two sides add the same float32 terms in
another order, at most 64 of them, which may differ by log2(64) = 6
roundings of 2**-24 each (3.6e-7 of the sum). Two families need more,
each by ``_atol``:

- R² and explained variance are 1 - a / b, with b a difference of two sums
  (Σy² and (Σy)²/N) about 4.7 times smaller than either for targets in
  0.5-10 (Σy² / (N·Var y) = (E[y]² + Var y) / Var y). So b moves by up to
  (4.7 + 1) · 3.6e-7 = 2.0e-6 of itself, a by 3.6e-7, and a / b (below 1.2
  here) by 1.2 · 2.4e-6 = 2.9e-6: ``ATOL_RATIO = 4e-6``.
- Tweedie deviance at a power other than 0, 1 or 2 adds three terms that
  nearly cancel, each up to 4·sqrt(10) = 12.6 for values up to 10, each
  computed with a ``pow`` and a division (2 ulps of 2**-23 relative): the
  mean moves by up to 2 · 3 · 12.6 · 2**-23 = 9e-6, ``ATOL_TWEEDIE = 1e-5``,
  and its sum state by 64 times that.
"""
import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional as ref_fn
import metrics_tpu_torch as port
import metrics_tpu_torch.functional as port_fn
from metrics_tpu_torch.utils.convert import state_dict_from_reference

ATOL, RTOL = 1e-6, 2.0 ** -20
ATOL_RATIO, ATOL_TWEEDIE = 4e-6, 1e-5
N, D = 32, 3

_rng = np.random.RandomState(6)
TARGET = _rng.uniform(0.5, 10.0, (2, N)).astype(np.float32)
PREDS = (TARGET * np.exp(_rng.normal(0.0, 0.1, (2, N)))).astype(np.float32)
TARGET_2D = _rng.uniform(0.5, 10.0, (2, N, D)).astype(np.float32)
PREDS_2D = (TARGET_2D * np.exp(_rng.normal(0.0, 0.3, (2, N, D)))).astype(np.float32)
INT_TARGET = _rng.randint(0, 10, (2, N))
INT_PREDS = _rng.randint(0, 10, (2, N))
SIGNED_TARGET = _rng.normal(0.0, 2.0, (2, N)).astype(np.float32)
SIGNED_TARGET[0, :3] = 0.0  # MAPE's and SMAPE's epsilon clip
SIGNED_PREDS = (SIGNED_TARGET + _rng.normal(0.0, 1.0, (2, N))).astype(np.float32)
SIGNED_PREDS[0, 2] = 0.0  # both zero: SMAPE's 0 / epsilon
EMBED_TARGET = _rng.normal(0.0, 1.0, (2, N, D)).astype(np.float32)
EMBED_PREDS = (EMBED_TARGET + _rng.normal(0.0, 1.0, (2, N, D))).astype(np.float32)

DATA = {
    "1d": (PREDS, TARGET),
    "2d": (PREDS_2D, TARGET_2D),
    "int": (INT_PREDS, INT_TARGET),
    "signed": (SIGNED_PREDS, SIGNED_TARGET),
    "embed": (EMBED_PREDS, EMBED_TARGET),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want, atol=ATOL, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _pair(batch, data, backend):
    p, t = DATA[data]
    p, t = p[batch], t[batch]
    if backend == "jax":
        return jnp.asarray(p), jnp.asarray(t)
    return torch.from_numpy(np.ascontiguousarray(p)), torch.from_numpy(np.ascontiguousarray(t))


def _atol(name, kwargs):
    """The value tolerance of a functional or module (see the module docstring)."""
    if name in ("r2_score", "explained_variance", "R2Score", "ExplainedVariance"):
        return ATOL_RATIO
    if name in ("tweedie_deviance_score", "TweedieDevianceScore") and kwargs.get("power", 0.0) not in (0, 1, 2):
        return ATOL_TWEEDIE
    return ATOL


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# functionals
# ---------------------------------------------------------------------------

FUNCTIONAL_CASES = {
    "mse-1d": ("mean_squared_error", {}, "1d"),
    "mse-2d": ("mean_squared_error", {}, "2d"),
    "mse-int": ("mean_squared_error", {}, "int"),
    "rmse-1d": ("mean_squared_error", {"squared": False}, "1d"),
    "rmse-signed": ("mean_squared_error", {"squared": False}, "signed"),
    "mae-1d": ("mean_absolute_error", {}, "1d"),
    "mae-2d": ("mean_absolute_error", {}, "2d"),
    "mae-int": ("mean_absolute_error", {}, "int"),
    "msle-1d": ("mean_squared_log_error", {}, "1d"),
    "msle-2d": ("mean_squared_log_error", {}, "2d"),
    "msle-int": ("mean_squared_log_error", {}, "int"),
    "mape-1d": ("mean_absolute_percentage_error", {}, "1d"),
    "mape-2d": ("mean_absolute_percentage_error", {}, "2d"),
    "mape-zero-target": ("mean_absolute_percentage_error", {}, "signed"),
    "mape-int": ("mean_absolute_percentage_error", {}, "int"),
    "smape-1d": ("symmetric_mean_absolute_percentage_error", {}, "1d"),
    "smape-zero": ("symmetric_mean_absolute_percentage_error", {}, "signed"),
    "smape-int": ("symmetric_mean_absolute_percentage_error", {}, "int"),
    "r2-1d": ("r2_score", {}, "1d"),
    "r2-2d-uniform": ("r2_score", {}, "2d"),
    "r2-2d-raw": ("r2_score", {"multioutput": "raw_values"}, "2d"),
    "r2-2d-variance": ("r2_score", {"multioutput": "variance_weighted"}, "2d"),
    "r2-adjusted": ("r2_score", {"adjusted": 3}, "1d"),
    "r2-adjusted-divzero": ("r2_score", {"adjusted": N - 1}, "1d"),
    "r2-adjusted-too-many": ("r2_score", {"adjusted": N}, "1d"),
    "r2-int": ("r2_score", {}, "int"),
    "ev-1d": ("explained_variance", {}, "1d"),
    "ev-2d-uniform": ("explained_variance", {}, "2d"),
    "ev-2d-raw": ("explained_variance", {"multioutput": "raw_values"}, "2d"),
    "ev-2d-variance": ("explained_variance", {"multioutput": "variance_weighted"}, "2d"),
    "ev-int": ("explained_variance", {}, "int"),
    "tweedie-0": ("tweedie_deviance_score", {"power": 0.0}, "signed"),
    "tweedie-1": ("tweedie_deviance_score", {"power": 1.0}, "1d"),
    "tweedie-2": ("tweedie_deviance_score", {"power": 2.0}, "1d"),
    "tweedie-1.5": ("tweedie_deviance_score", {"power": 1.5}, "1d"),
    "tweedie-3": ("tweedie_deviance_score", {"power": 3.0}, "1d"),
    "tweedie-neg": ("tweedie_deviance_score", {"power": -0.5}, "1d"),
    "tweedie-2d": ("tweedie_deviance_score", {"power": 2.0}, "2d"),
    "pearson-1d": ("pearson_corrcoef", {}, "1d"),
    "pearson-signed": ("pearson_corrcoef", {}, "signed"),
    "pearson-int": ("pearson_corrcoef", {}, "int"),
    "spearman-1d": ("spearman_corrcoef", {}, "1d"),
    "spearman-int-ties": ("spearman_corrcoef", {}, "int"),
    "cosine-sum": ("cosine_similarity", {}, "embed"),
    "cosine-mean": ("cosine_similarity", {"reduction": "mean"}, "embed"),
    "cosine-none": ("cosine_similarity", {"reduction": "none"}, "embed"),
    "cosine-None": ("cosine_similarity", {"reduction": None}, "embed"),
    "cosine-1d": ("cosine_similarity", {}, "signed"),
    "cosine-int": ("cosine_similarity", {}, "int"),  # the float32 cast of update
}


@functools.lru_cache(maxsize=None)
def _ref(case):
    """The JAX package's value of one functional case (and the warnings it
    raised), computed once."""
    name, kwargs, data = FUNCTIONAL_CASES[case]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        value = np.asarray(getattr(ref_fn, name)(*_pair(0, data, "jax"), **kwargs))
    return value, sorted({(w.category.__name__, str(w.message)) for w in caught})


@pytest.mark.parametrize("case", FUNCTIONAL_CASES)
def test_functional_matches_reference(case):
    name, kwargs, data = FUNCTIONAL_CASES[case]
    want, want_warnings = _ref(case)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = getattr(port_fn, name)(*_pair(0, data, "torch"), **kwargs)
    assert sorted({(w.category.__name__, str(w.message)) for w in caught}) == want_warnings
    _assert_close(got, want, atol=_atol(name, kwargs))


@pytest.mark.parametrize("name", [
    "mean_squared_error", "mean_absolute_error", "mean_squared_log_error", "mean_absolute_percentage_error",
    "symmetric_mean_absolute_percentage_error", "r2_score", "explained_variance", "pearson_corrcoef",
    "spearman_corrcoef", "cosine_similarity", "tweedie_deviance_score",
])
def test_shape_mismatch_raises_like_reference(name):
    p, t = PREDS[0], TARGET[0, :-1]
    with pytest.raises(Exception) as want:
        getattr(ref_fn, name)(jnp.asarray(p), jnp.asarray(t))
    with pytest.raises(want.type):
        getattr(port_fn, name)(torch.from_numpy(p), torch.from_numpy(np.ascontiguousarray(t)))


_POS = TARGET[0]
ERROR_CASES = {
    "r2-one-sample": ("r2_score", {}, _POS[:1], _POS[:1]),
    "r2-3d": ("r2_score", {}, PREDS_2D[0].reshape(4, 8, 3), TARGET_2D[0].reshape(4, 8, 3)),
    "r2-bad-multioutput": ("r2_score", {"multioutput": "bad"}, PREDS[0], TARGET[0]),
    "r2-negative-adjusted": ("r2_score", {"adjusted": -1}, PREDS[0], TARGET[0]),
    "ev-bad-multioutput": ("explained_variance", {"multioutput": "bad"}, PREDS[0], TARGET[0]),
    "tweedie-0.5": ("tweedie_deviance_score", {"power": 0.5}, PREDS[0], TARGET[0]),
    "tweedie-1-negative-target": ("tweedie_deviance_score", {"power": 1.0}, PREDS[0], SIGNED_TARGET[0]),
    "tweedie-1-zero-pred": ("tweedie_deviance_score", {"power": 1.0}, SIGNED_TARGET[0], TARGET[0]),
    "tweedie-2-zero-target": ("tweedie_deviance_score", {"power": 2.0}, PREDS[0], SIGNED_TARGET[0]),
    "tweedie-neg-zero-pred": ("tweedie_deviance_score", {"power": -1.0}, SIGNED_TARGET[0], TARGET[0]),
    "tweedie-1.5-negative-target": ("tweedie_deviance_score", {"power": 1.5}, PREDS[0], SIGNED_TARGET[0]),
    "tweedie-3-zero-target": ("tweedie_deviance_score", {"power": 3.0}, PREDS[0], SIGNED_TARGET[0]),
    "pearson-2d": ("pearson_corrcoef", {}, PREDS_2D[0], TARGET_2D[0]),
    "spearman-2d": ("spearman_corrcoef", {}, PREDS_2D[0], TARGET_2D[0]),
    "spearman-mixed-dtypes": ("spearman_corrcoef", {}, PREDS[0], INT_TARGET[0]),
    "cosine-bad-reduction": ("cosine_similarity", {"reduction": "bad"}, EMBED_PREDS[0], EMBED_TARGET[0]),
}


@pytest.mark.parametrize("case", ERROR_CASES)
def test_error_matches_reference(case):
    """The same exception class, and the same message where the JAX
    package words its own."""
    name, kwargs, p, t = ERROR_CASES[case]
    with pytest.raises(Exception) as want:
        getattr(ref_fn, name)(jnp.asarray(p), jnp.asarray(t), **kwargs)
    with pytest.raises(want.type) as got:
        getattr(port_fn, name)(torch.from_numpy(np.ascontiguousarray(p)), torch.from_numpy(np.ascontiguousarray(t)),
                               **kwargs)
    if want.type in (ValueError, TypeError):
        # dtype names differ: torch.int64 here, int32 there (x64 is off)
        got_msg = str(got.value).replace("torch.", "").replace("int64", "int32")
        assert got_msg == str(want.value), (got_msg, str(want.value))


def test_r2score_alias_warns_and_matches():
    with pytest.warns(DeprecationWarning) as want:
        v_ref = ref_fn.r2score(*_pair(0, "1d", "jax"))
    with pytest.warns(DeprecationWarning) as got:
        v_port = port_fn.r2score(*_pair(0, "1d", "torch"))
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    _assert_close(v_port, v_ref)


def test_regression_exports_match_reference():
    import metrics_tpu.functional.regression as ref_reg_fn
    import metrics_tpu.regression as ref_reg
    import metrics_tpu_torch.functional.regression as port_reg_fn
    import metrics_tpu_torch.regression as port_reg

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_") and callable(getattr(mod, n))}

    assert public(port_reg) == public(ref_reg) and len(public(port_reg)) == 11
    assert public(port_reg_fn) == public(ref_reg_fn) and len(public(port_reg_fn)) == 12
    for name in public(ref_reg):
        assert getattr(port, name) is getattr(port_reg, name)
    for name in public(ref_reg_fn):
        assert getattr(port_fn, name) is getattr(port_reg_fn, name)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

MODULE_CASES = {
    "mse": ("MeanSquaredError", {}, "1d"),
    "rmse": ("MeanSquaredError", {"squared": False}, "2d"),
    "mae": ("MeanAbsoluteError", {}, "int"),
    "msle": ("MeanSquaredLogError", {}, "1d"),
    "mape": ("MeanAbsolutePercentageError", {}, "signed"),
    "smape": ("SymmetricMeanAbsolutePercentageError", {}, "signed"),
    "r2": ("R2Score", {}, "1d"),
    "r2-multioutput": ("R2Score", {"num_outputs": D, "multioutput": "raw_values"}, "2d"),
    "r2-variance": ("R2Score", {"num_outputs": D, "multioutput": "variance_weighted"}, "2d"),
    "r2-adjusted": ("R2Score", {"adjusted": 2}, "1d"),
    "ev": ("ExplainedVariance", {}, "1d"),
    "ev-multioutput": ("ExplainedVariance", {"multioutput": "raw_values"}, "2d"),
    "ev-variance": ("ExplainedVariance", {"multioutput": "variance_weighted"}, "2d"),
    "tweedie-0": ("TweedieDevianceScore", {}, "signed"),
    "tweedie-1.5": ("TweedieDevianceScore", {"power": 1.5}, "1d"),
    "pearson": ("PearsonCorrcoef", {}, "1d"),
    "pearson-int": ("PearsonCorrcoef", {}, "int"),
    "spearman": ("SpearmanCorrcoef", {}, "int"),
    "cosine": ("CosineSimilarity", {}, "embed"),
    "cosine-none": ("CosineSimilarity", {"reduction": "none"}, "embed"),
}

# the count of each module, compared exactly (int64 in the port, int32 or
# float32 in the JAX package)
COUNTS = {"total", "num_observations", "n_obs", "n_total"}


def _make(case, backend, capacity=None):
    cls, kwargs, _ = MODULE_CASES[case]
    m = _quiet(getattr(ref, cls), **kwargs) if backend == "jax" else _quiet(getattr(port, cls), device="cpu", **kwargs)
    return m.with_capacity(capacity) if capacity else m


@functools.lru_cache(maxsize=None)
def _ref_module(case):
    """The JAX module's two forward values, accumulated value and state
    dict (every state persistent), computed once."""
    data = MODULE_CASES[case][2]
    m = _make(case, "jax")
    m.persistent(True)
    steps = [np.asarray(m(*_pair(b, data, "jax"))) for b in range(2)]
    return steps, np.asarray(m.compute()), m.state_dict()


def _check_states(m_port, sd_ref, atol=ATOL):
    """Counts exactly, float states within ``atol`` (plus RTOL)."""
    for name, v in m_port._state.items():
        want = sd_ref[name]
        got = v if isinstance(v, torch.Tensor) else torch.cat(list(v)) if isinstance(v, list) else v.values()
        want = np.concatenate([np.atleast_1d(x) for x in want]) if isinstance(want, list) else np.asarray(want)
        if name in COUNTS:
            np.testing.assert_array_equal(_np(got), want, err_msg=name)
        else:
            _assert_close(got, want, atol=atol)


def _module_atol(case):
    cls, kwargs, _ = MODULE_CASES[case]
    return _atol(cls, kwargs)


@pytest.mark.parametrize("case", MODULE_CASES)
def test_module_forward_and_compute_match_reference(case):
    steps, want, sd_ref = _ref_module(case)
    data = MODULE_CASES[case][2]
    atol = _module_atol(case)
    m = _make(case, "torch")
    for b in range(2):
        _assert_close(m(*_pair(b, data, "torch")), steps[b], atol=atol)
    _assert_close(m.compute(), want, atol=atol)
    # a sum state of 2N terms, each within the mean's bound: 2N times it
    _check_states(m, sd_ref, 2 * N * ATOL_TWEEDIE if atol == ATOL_TWEEDIE else ATOL)


@pytest.mark.parametrize("case", ["mse", "r2-multioutput", "ev-multioutput", "tweedie-1.5", "pearson", "spearman",
                                  "cosine"])
def test_module_update_reset_update(case):
    """``update`` accumulates as ``forward`` does; ``reset`` restores the
    declared defaults (ExplainedVariance's states go back to 0-d), and the
    metric accumulates the same again."""
    _, want, _ = _ref_module(case)
    data = MODULE_CASES[case][2]
    m = _make(case, "torch")
    defaults = {k: (v.shape, v.dtype) for k, v in m._state.items() if isinstance(v, torch.Tensor)}
    for _ in range(2):
        for b in range(2):
            m.update(*_pair(b, data, "torch"))
        _assert_close(m.compute(), want, atol=_module_atol(case))
        m.reset()
        assert {k: (v.shape, v.dtype) for k, v in m._state.items() if isinstance(v, torch.Tensor)} == defaults


def test_explained_variance_states_take_the_batch_shape():
    m = port.ExplainedVariance(device="cpu")
    assert all(v.shape == () for v in m._state.values())
    m.update(*_pair(0, "2d", "torch"))
    assert all(v.shape == (D,) for k, v in m._state.items() if k != "n_obs") and m.n_obs.shape == ()
    sd_m = m.clone()
    sd_m.persistent(True)
    fresh = port.ExplainedVariance(device="cpu")
    fresh.load_state_dict(sd_m.state_dict())
    fresh.update(*_pair(1, "2d", "torch"))
    m.update(*_pair(1, "2d", "torch"))
    _assert_close(fresh.compute(), m.compute(), atol=0.0, rtol=0.0)
    m.reset()
    assert all(v.shape == () for v in m._state.values())


@pytest.mark.parametrize("case", ["spearman", "cosine"])
def test_cat_modules_under_capacity_equal_list_mode(case):
    _, want, _ = _ref_module(case)
    data = MODULE_CASES[case][2]
    m = _make(case, "torch", capacity=2 * N)
    listed = _make(case, "torch")
    for b in range(2):
        m.update(*_pair(b, data, "torch"))
        listed.update(*_pair(b, data, "torch"))
    assert type(m.preds).__name__ == "CatBuffer"
    assert torch.equal(m.compute(), listed.compute())
    _assert_close(m.compute(), want)


MODULE_ERRORS = {
    "r2-negative-adjusted": ("R2Score", {"adjusted": -1}),
    "r2-bad-multioutput": ("R2Score", {"multioutput": "bad"}),
    "ev-bad-multioutput": ("ExplainedVariance", {"multioutput": "bad"}),
    "tweedie-0.5": ("TweedieDevianceScore", {"power": 0.5}),
    "cosine-bad-reduction": ("CosineSimilarity", {"reduction": "bad"}),
}


@pytest.mark.parametrize("case", MODULE_ERRORS)
def test_module_constructor_errors_match_reference(case):
    cls, kwargs = MODULE_ERRORS[case]
    with pytest.raises(Exception) as want:
        getattr(ref, cls)(**kwargs)
    with pytest.raises(want.type, match=None) as got:
        getattr(port, cls)(device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


def test_r2_module_needs_two_samples_like_reference():
    m_ref, m_port = ref.R2Score(), port.R2Score(device="cpu")
    m_ref.update(jnp.asarray(PREDS[0, :1]), jnp.asarray(TARGET[0, :1]))
    m_port.update(torch.from_numpy(PREDS[0, :1]), torch.from_numpy(TARGET[0, :1]))
    with pytest.raises(ValueError, match="at least two samples"):
        m_ref.compute()
    with pytest.raises(ValueError, match="at least two samples"):
        m_port.compute()


def test_r2score_module_alias_warns_and_matches():
    from metrics_tpu.regression.r2score import R2Score as RefAlias

    from metrics_tpu_torch.regression.r2score import R2Score as PortAlias

    with pytest.warns(DeprecationWarning, match="deprecated alias"):
        m_ref = RefAlias()
    with pytest.warns(DeprecationWarning, match="deprecated alias"):
        m_port = PortAlias(device="cpu")
    assert isinstance(m_port, port.R2Score)
    m_ref.update(*_pair(0, "1d", "jax"))
    m_port.update(*_pair(0, "1d", "torch"))
    _assert_close(m_port.compute(), m_ref.compute())


def test_spearman_warns_like_reference():
    with pytest.warns(UserWarning) as want:
        ref.SpearmanCorrcoef()
    with pytest.warns(UserWarning) as got:
        port.SpearmanCorrcoef(device="cpu")
    assert [str(w.message) for w in got] == [str(w.message) for w in want]


@pytest.mark.parametrize("case", ["mse", "r2-multioutput", "ev-multioutput", "tweedie-1.5", "pearson", "spearman",
                                  "cosine"])
def test_reference_state_carried_across_computes_the_same(case):
    """A JAX-side accumulation loaded into the port computes the JAX value:
    int32 counts widen to int64, float moments stay float32, cat lists stay
    lists."""
    _, want, sd_ref = _ref_module(case)
    m = _make(case, "torch")
    m.load_state_dict(state_dict_from_reference(sd_ref, device="cpu"), strict=True)
    assert all(v.dtype == torch.int64 for k, v in m._state.items() if k in ("total", "num_observations"))
    _assert_close(m.compute(), want, atol=_module_atol(case))


def test_reference_cat_buffer_state_carried_across():
    m_ref = _quiet(ref.SpearmanCorrcoef).with_capacity(2 * N)
    m_ref.persistent(True)
    for b in range(2):
        m_ref.update(*_pair(b, "1d", "jax"))
    m = _quiet(port.SpearmanCorrcoef, device="cpu").with_capacity(2 * N)
    m.load_state_dict(state_dict_from_reference(m_ref.state_dict(), device="cpu"), strict=True)
    assert type(m.preds).__name__ == "CatBuffer" and len(m.preds) == 2 * N
    _assert_close(m.compute(), m_ref.compute())
