"""The whole public surface of the port against the JAX package, on the CPU.

Every callable of ``metrics_tpu.functional`` with a namesake in
``metrics_tpu_torch.functional``, and every ``Metric`` subclass that
``metrics_tpu`` exports with a counterpart in ``metrics_tpu_torch``, runs on
the same numpy inputs in both packages, over a grid of input kinds (binary,
multiclass, multilabel, regression, planted NaN/+inf/-inf, empty batches,
half-precision preds against integer and float targets, integer targets,
signals, images, retrieval queries and sentences). The lists are read off
the two packages, so a new functional or metric joins the sweep by itself.

The rule of a case:

- both packages raise: the case passes (the input is not one the callable
  takes);
- exactly one raises: the case fails;
- both return: the same structure, shapes and values within rtol 1e-4 /
  atol 1e-5, NaN equal to NaN and each inf where the other has it; for
  half-precision inputs the float width too (a half result stays half);
  otherwise values, not dtypes (the port counts in int64, the JAX package in
  int32: ROADMAP C.9).

``STANDING_RULES`` may compare a case another way, and only by a C.9
standing rule of ROADMAP.md: a fault is repaired, never listed there.

A class is built with its defaults (``num_classes`` where it needs one, and
``CLASS_ARGS`` where it needs more), updated on a kind's batch and then on
the batch reversed, then computed.

Tier-1 runs each functional on its family's kinds (``FAMILY_KINDS``, or
its own in ``FUNCTIONAL_KINDS``), checks that each returns a value in both
packages on one of them, and runs each class on the first kind it takes;
``-m slow`` runs every other case of the grid. Nearly all of the time is the JAX package compiling each of its
ops for every new shape and dtype. The model-backed metrics (FID, KID, IS,
LPIPS, BERTScore) are held to the JAX draws in their own files
(``tests/test_torch_{image,inception,lpips,bert,golden_pipeline_scores}.py``).

The repairs this sweep found (ROADMAP C.27-C.34) each have a case of their
own at the end, at the values of the probes that found them.
"""
import functools
import inspect
import operator
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu.functional as ref_f
import metrics_tpu_torch as port
import metrics_tpu_torch.functional as port_f

RTOL, ATOL = 1e-4, 1e-5
N, C, B, T, SPK = 24, 4, 3, 32, 2
HALVES = ("float16", "bfloat16")


class _Cast:
    """A float32 numpy array each package casts to ``dtype`` itself (numpy
    has no bfloat16)."""

    def __init__(self, data, dtype):
        self.data, self.dtype = data, dtype


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _planted(a, value):
    a = a.copy()
    a[2] = value
    return a


WORDS = "the cat sat on a mat quick brown fox jumps over lazy dog hello there".split()


def _sentences(rng, n):
    return [" ".join(rng.choice(WORDS, rng.randint(1, 7))) for _ in range(n)]


def _make_kinds():
    """name -> (args, number of classes), drawn from one seed. The first two
    draws are the C.28 probe's (``rand(24)`` against ``randint(0, 2, 24)``)."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    score, label = rng.rand(N).astype(f32), rng.randint(0, 2, N)
    probs, mc_target = _softmax(rng.randn(N, C)), rng.randint(0, C, N)
    ml_preds, ml_target = rng.rand(N, C).astype(f32), rng.randint(0, 2, (N, C))
    reg_p, reg_t = rng.randn(N).astype(f32), rng.randn(N).astype(f32)
    pos_p, pos_t = (rng.rand(N) + 0.1).astype(f32), (rng.rand(N) + 0.1).astype(f32)
    sig_p, sig_t = rng.randn(B, T).astype(f32), rng.randn(B, T).astype(f32)
    sig_int = rng.randint(-3, 4, (B, T))
    spk_p, spk_t = rng.randn(B, SPK, T).astype(f32), rng.randn(B, SPK, T).astype(f32)
    spk_int = rng.randint(-3, 4, (B, SPK, T))
    perm = np.stack([rng.permutation(SPK) for _ in range(B)])
    img_p, img_t = rng.rand(2, 3, 16, 16).astype(f32), rng.rand(2, 3, 16, 16).astype(f32)
    ret_p, ret_t = rng.rand(N).astype(f32), rng.randint(0, 2, N)
    ret_i = np.repeat(np.arange(4), N // 4)
    hyp, refs = _sentences(rng, 4), _sentences(rng, 4)
    kinds = {
        "binary": ((score, label), 2),
        "multiclass": ((probs, mc_target), C),
        "multiclass_labels": ((rng.randint(0, C, N), mc_target), C),
        "multilabel": ((ml_preds, ml_target), C),
        "regression": ((reg_p, reg_t), 2),
        "positive": ((pos_p, pos_t), 2),
        "multioutput": ((rng.randn(N, 3).astype(f32), rng.randn(N, 3).astype(f32)), 3),
        "empty_binary": ((np.zeros(0, f32), np.zeros(0, np.int64)), 2),
        "empty_regression": ((np.zeros(0, f32), np.zeros(0, f32)), 2),
        "empty_multiclass": ((np.zeros((0, C), f32), np.zeros(0, np.int64)), C),
        "int_target_regression": ((pos_p, rng.randint(1, 5, N)), 2),
        "signals": ((sig_p, sig_t), 2),
        "signals_int_target": ((sig_p, sig_int), 2),
        "speakers": ((spk_p, spk_t), 2),
        "speakers_int_target": ((spk_p, spk_int), 2),
        "permutation": ((spk_p, perm), 2),
        "images": ((img_p, img_t), 2),
        "image": ((img_p,), 2),
        "retrieval": ((ret_p, ret_t, ret_i), 2),
        "curve": ((np.sort(score), pos_p), 2),
        "sentences": ((hyp, refs), 2),
        "corpus": (([[r.split()] for r in refs], [h.split() for h in hyp]), 2),
    }
    for name, value in (("nan", np.nan), ("posinf", np.inf), ("neginf", -np.inf)):
        kinds[f"score_{name}"] = ((_planted(score, value), label), 2)
        kinds[f"multiclass_{name}"] = ((_planted(probs, value), mc_target), C)
        kinds[f"regression_{name}"] = ((_planted(reg_p, value), reg_t), 2)
    for half in HALVES:
        kinds[f"{half}_int_target"] = ((_Cast(score, half), label), 2)
        kinds[f"{half}_float_target"] = ((_Cast(pos_p, half), pos_t), 2)
        kinds[f"{half}_multiclass"] = ((_Cast(probs, half), mc_target), C)
    return kinds


KINDS = _make_kinds()


def _half_of(kind):
    return next((a.dtype for a in KINDS[kind][0] if isinstance(a, _Cast)), None)


#: Tier-1's kinds for each family of the two packages, its main kind first:
#: the main float32 batch and the same with NaN, +inf and -inf planted in it
#: (the same shapes, so the JAX package compiles nothing new for them).
#: Every other (callable, kind) case runs under ``-m slow``, the empty
#: batches among them: the JAX package compiles each of its ops anew for
#: every shape and dtype, which is most of the sweep's time. The repairs'
#: own cases below hold the empty, integer, half and multiclass forms the
#: sweep found faults in.
_NONFINITE = ("nan", "posinf", "neginf")
_REGRESSION = ("regression",) + tuple(f"regression_{v}" for v in _NONFINITE) + ("positive",)
_BINARY = ("binary",) + tuple(f"score_{v}" for v in _NONFINITE)
FAMILY_KINDS = {
    "classification": _BINARY,
    "regression": _REGRESSION,
    "audio": ("speakers",),
    "image": ("images",),
    "retrieval": _BINARY,
    "text": ("sentences", "corpus"),
    "self_supervised": ("multilabel",),
    # the wrappers and the runtime's own metrics run on regression members here
    "wrappers": _REGRESSION,
    "core": _REGRESSION,
}
#: A class whose family's kinds it does not take (retrieval: ``indexes``)
#: tries these next, then every kind.
CLASS_KINDS = ("retrieval",)


def _family(obj):
    """``classification`` for ``metrics_tpu.functional.classification.auroc``
    or ``metrics_tpu.classification.auroc``."""
    parts = obj.__module__.split(".")
    return parts[2] if parts[1] == "functional" else parts[1]


def _to(pkg, x):
    if isinstance(x, _Cast):
        if pkg is ref:
            return jnp.asarray(x.data).astype(getattr(jnp, x.dtype))
        return torch.from_numpy(x.data).to(getattr(torch, x.dtype))
    if isinstance(x, np.ndarray):
        return jnp.asarray(x) if pkg is ref else torch.from_numpy(x.copy())
    return x


def _inputs(pkg, kind, reverse=False):
    """The kind's arguments for ``pkg``; ``reverse`` takes the batch in
    reverse order (a class's second update: the same shapes, so the JAX
    package compiles nothing new)."""
    out = []
    for a in KINDS[kind][0]:
        if reverse:
            data = (a.data if isinstance(a, _Cast) else a)[::-1].copy()
            a = _Cast(data, a.dtype) if isinstance(a, _Cast) else data
        out.append(_to(pkg, a))
    return out


# ---- results -----------------------------------------------------------------

def _leaves(x):
    """(dtype name, float64 array) of every array in a result, in order."""
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    if isinstance(x, torch.Tensor):
        return [(str(x.dtype).replace("torch.", ""), x.detach().to(torch.float64).numpy())]
    if isinstance(x, str):
        return [("str", x)]
    arr = np.asarray(x)
    name = str(arr.dtype)
    if isinstance(x, (bool, int, float)):  # a Python scalar: no width of its own
        name = type(x).__name__
    return [(name, arr.astype(np.float64))]


def _call(fn):
    """(None, result) or (exception, None)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return None, fn()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as err:  # noqa: BLE001 - a raise is a result of the case (bert_score's
            return err, None  # tokenizer failure is a BaseException in both packages)


def _integer(name):
    return name in ("int32", "int64", "int16", "int8", "uint8", "bool", "int")


def _assert_same(want, got, half, what, compare=None):
    """Hold the port's result ``got`` to the JAX package's ``want``;
    ``half`` is the half dtype of the inputs, if any."""
    want_leaves, got_leaves = _leaves(want), _leaves(got)
    assert len(want_leaves) == len(got_leaves), f"{what}: {len(got_leaves)} arrays, JAX {len(want_leaves)}"
    for i, ((wd, w), (gd, g)) in enumerate(zip(want_leaves, got_leaves)):
        at = f"{what} [{i}]"
        if wd == "str" or gd == "str":
            assert (wd, w) == (gd, g), at
            continue
        assert w.shape == g.shape, f"{at}: shape {g.shape}, JAX {w.shape}"
        if half and not (_integer(wd) and _integer(gd)) and "float" in wd + gd:
            assert wd == gd, f"{at}: dtype {gd}, JAX {wd}"
        assert np.array_equal(np.isnan(w), np.isnan(g)), f"{at}: NaN at {np.isnan(g)}, JAX {np.isnan(w)}\n{g}\n{w}"
        assert np.array_equal(np.isposinf(w), np.isposinf(g)), f"{at}: +inf {g}, JAX {w}"
        assert np.array_equal(np.isneginf(w), np.isneginf(g)), f"{at}: -inf {g}, JAX {w}"
        finite = np.isfinite(w)
        (compare or _close)(w[finite], g[finite], half, at)


def _close(w, g, half, at):
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=at)


def _half_rounding(w, g, half, at):
    """Two ulps of the inputs' half dtype, on the value's scale."""
    eps = float(torch.finfo(getattr(torch, half)).eps)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=2 * eps, atol=2 * eps * scale, err_msg=at)


#: The C.9 standing rules (ROADMAP.md §C) a case may be compared under
#: instead of the plain rule, each with the cases it covers. A fault never
#: goes here: it is repaired.
STANDING_RULES = {
    # HALF_ROUNDING: XLA computes a fused elementwise chain of half inputs
    # with one rounding (its CPU backend drops the half round trip between
    # fused ops), torch rounds after every op
    # (tests/test_torch_half_precision.py::HALF_ROUNDING): the log1p squares
    # of MSLE.
    "HALF_ROUNDING": (_half_rounding, {
        ("mean_squared_log_error", "float16_int_target"), ("MeanSquaredLogError", "float16_int_target"),
    }),
}
EXCUSED = {case: rule for rule, (_, cases) in STANDING_RULES.items() for case in cases}


def test_standing_rules_excuse_only_what_they_must():
    """Each excused case fails the plain rule: an entry the port has since
    come to meet exactly is taken out."""
    for case in sorted(EXCUSED):
        name, kind = case
        outcomes = _functional_outcomes if name in FUNCTIONALS else _class_outcomes
        (w_err, want), (g_err, got) = outcomes(name, kind)
        assert w_err is None and g_err is None, case
        with pytest.raises(AssertionError):
            _assert_same(want, got, _half_of(kind), str(case))


def _compare_for(case):
    rule = EXCUSED.get(case)
    return STANDING_RULES[rule][0] if rule else None


def _check(case, want_outcome, got_outcome):
    (w_err, want), (g_err, got) = want_outcome, got_outcome
    if w_err is not None and g_err is not None:
        return
    assert g_err is None, f"{case}: the port raises {g_err!r}, JAX returns {want!r}"
    assert w_err is None, f"{case}: JAX raises {w_err!r}, the port returns {got!r}"
    _assert_same(want, got, _half_of(case[1]), str(case), _compare_for(case))


# ---- the functionals ---------------------------------------------------------

def _functional_names():
    return sorted(n for n in dir(ref_f) if not n.startswith("_") and inspect.isfunction(getattr(ref_f, n))
                  and callable(getattr(port_f, n, None)))


FUNCTIONALS = _functional_names()


def _word_vectors(sentences, max_length):
    """A user tokenizer for ``bert_score``: each word's seeded vector as its
    "ids" (the model is the identity), [CLS]/[SEP] framing."""
    table = np.random.RandomState(1).randn(len(WORDS), 8).astype(np.float32)
    ids = np.zeros((len(sentences), max_length, 8), np.float32)
    mask = np.zeros((len(sentences), max_length), np.int32)
    for row, s in enumerate(sentences):
        words = s.split()[: max_length - 2]
        for col, w in enumerate(words, start=1):
            ids[row, col] = table[WORDS.index(w)] if w in WORDS else 0.0
        mask[row, : len(words) + 2] = 1
    return {"input_ids": ids, "attention_mask": mask}


def _identity_model(input_ids, attention_mask):
    return input_ids


#: Tier-1's kinds of a functional that takes other inputs than its family's
#: (a curve's monotonic x and its y; class probabilities; rows of two
#: distributions; one image; a permutation of the speakers).
FUNCTIONAL_KINDS = {
    "auc": ("curve",),
    "dice_score": ("multiclass",),
    "image_gradients": ("image",),
    "kl_divergence": ("multilabel",),
    "kldivergence": ("multilabel",),
    "pit_permutate": ("permutation",),
}

#: Arguments a functional needs beyond its inputs, for each package; a
#: required ``num_classes`` takes the kind's number of classes.
FUNCTIONAL_ARGS = {
    "pit": lambda pkg_f: {"metric_func": pkg_f.si_sdr},
    "bert_score": lambda pkg_f: {"model": _identity_model, "user_tokenizer": _word_vectors, "max_length": 10},
}


def _required(fn, skip):
    return [p.name for i, p in enumerate(inspect.signature(fn).parameters.values())
            if i >= skip and p.default is inspect.Parameter.empty
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def test_functional_arguments_cover_every_required_parameter():
    """A functional whose required parameters beyond its two inputs are not
    ``num_classes`` has its arguments in ``FUNCTIONAL_ARGS``, and every entry
    there names a swept functional."""
    needs = {n for n in FUNCTIONALS if set(_required(getattr(ref_f, n), 2)) - {"num_classes"}}
    assert needs == set(FUNCTIONAL_ARGS) - {"bert_score"}
    assert set(FUNCTIONAL_ARGS) | set(FUNCTIONAL_KINDS) <= set(FUNCTIONALS)
    assert len(FUNCTIONALS) >= 54


@pytest.fixture(autouse=True, scope="module")
def _builtin_sentence_splitter():
    """ROUGE's sentence splitter and stemmer without nltk in both packages
    for this module:
    importing nltk costs ~5 s, and without its ``punkt`` data both packages
    fall back to the same regex splitter anyway.
    ``tests/test_torch_text.py`` holds the nltk path."""
    import metrics_tpu.functional.text.rouge as ref_rouge
    import metrics_tpu_torch.functional.text.rouge as port_rouge

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_rouge, "_NLTK_AVAILABLE", False)
        mp.setattr(port_rouge, "_NLTK_AVAILABLE", False)
        yield
    _class_outcomes.cache_clear()  # the outcomes hold both packages' metrics
    _functional_outcomes.cache_clear()


def _functional_call(pkg, name, kind):
    pkg_f = ref_f if pkg is ref else port_f
    fn = getattr(pkg_f, name)
    kw = FUNCTIONAL_ARGS.get(name, lambda _: {})(pkg_f)
    if "num_classes" in _required(fn, 2):
        kw["num_classes"] = KINDS[kind][1]
    if pkg is port and name == "bert_score":
        kw["device"] = "cpu"
    return _call(lambda: fn(*_inputs(pkg, kind), **kw))


@functools.lru_cache(maxsize=None)
def _functional_outcomes(name, kind):
    return _functional_call(ref, name, kind), _functional_call(port, name, kind)


def _tier1_kinds(name):
    return FUNCTIONAL_KINDS.get(name, FAMILY_KINDS[_family(getattr(ref_f, name))])


def _functional_cases(tier1):
    """Tier-1's cases (``True``): each functional over its tier-1 kinds; or
    the rest."""
    return [(name, kind) for name in FUNCTIONALS for kind in sorted(KINDS) if (kind in _tier1_kinds(name)) == tier1]


@pytest.mark.parametrize("name,kind", _functional_cases(True))
def test_functional_matches_the_jax_package(name, kind):
    _check((name, kind), *_functional_outcomes(name, kind))


@pytest.mark.parametrize("name", FUNCTIONALS)
def test_functional_returns_on_one_of_its_tier1_kinds(name):
    """A functional that raises in both packages on every one of its tier-1
    kinds is compared on no value: it needs its own in ``FUNCTIONAL_KINDS``
    or ``FUNCTIONAL_ARGS``."""
    returns = [kind for kind in _tier1_kinds(name)
               if all(err is None for err, _ in _functional_outcomes(name, kind))]
    assert returns, f"{name} returns in both packages on none of {_tier1_kinds(name)}"


@pytest.mark.slow
@pytest.mark.parametrize("name,kind", _functional_cases(False))
def test_functional_matches_the_jax_package_off_tier1(name, kind):
    _check((name, kind), *_functional_outcomes(name, kind))


# ---- the Metric classes ------------------------------------------------------

MODEL_BACKED = ("FID", "KID", "IS", "LPIPS", "BERTScore")


def _metric_names():
    out = []
    for name in ref.__all__:
        cls = getattr(ref, name)
        if (inspect.isclass(cls) and issubclass(cls, ref.Metric) and cls is not ref.Metric
                and not inspect.isabstract(cls) and name not in MODEL_BACKED and hasattr(port, name)):
            out.append(name)
    return sorted(out)


METRICS = _metric_names()

#: Constructor arguments a class needs beyond ``num_classes``, for each
#: package (``pkg``, and ``kw``: the device of the port's members).
CLASS_ARGS = {
    "PIT": lambda pkg, kw: {"metric_func": (ref_f if pkg is ref else port_f).si_sdr},
    "BootStrapper": lambda pkg, kw: {"base_metric": pkg.MeanSquaredError(**kw), "num_bootstraps": 2,
                                     "sampling_strategy": "multinomial"},
    "BinnedRecallAtFixedPrecision": lambda pkg, kw: {"min_precision": 0.5},
    "CompositionalMetric": lambda pkg, kw: {"operator": operator.add, "metric_a": pkg.MeanSquaredError(**kw),
                                            "metric_b": pkg.MeanAbsoluteError(**kw)},
    "RetrievalCollection": lambda pkg, kw: {"metrics": {"mrr": pkg.RetrievalMRR(**kw)}},
}


def test_class_arguments_cover_every_required_parameter():
    needs = {n for n in METRICS if set(_required(getattr(ref, n).__init__, 1)) - {"num_classes"}}
    assert needs == set(CLASS_ARGS)
    assert not set(MODEL_BACKED) & set(METRICS) and len(METRICS) >= 50


def _class_run(pkg, name, kind):
    kw = {} if pkg is ref else {"device": "cpu"}
    cls = getattr(pkg, name)

    def run():
        args = CLASS_ARGS.get(name, lambda *_: {})(pkg, kw)
        if "num_classes" in _required(cls.__init__, 1):
            args["num_classes"] = KINDS[kind][1]
        # a wrapper and a composite live on their members' device
        m = cls(**args, **(kw if name not in ("BootStrapper", "CompositionalMetric") else {}))
        for reverse in (False, True):
            m.update(*_inputs(pkg, kind, reverse))
        return m.compute()

    return _call(run)


@functools.lru_cache(maxsize=None)
def _class_outcomes(name, kind):
    return _class_run(ref, name, kind), _class_run(port, name, kind)


@pytest.mark.parametrize("name", METRICS)
def test_class_matches_the_jax_package_on_its_first_kind(name):
    """Tier-1: the class on the first kind that either package takes, its
    family's kinds first."""
    family = FAMILY_KINDS[_family(getattr(ref, name))] + CLASS_KINDS
    for kind in family + tuple(k for k in KINDS if k not in family):
        want, got = _class_outcomes(name, kind)
        if want[0] is None or got[0] is None:
            _check((name, kind), want, got)
            return
    pytest.fail(f"{name} takes no kind of the sweep")


@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", METRICS)
def test_class_matches_the_jax_package(name, kind):
    _check((name, kind), *_class_outcomes(name, kind))


# ---- the repairs (ROADMAP C.27-C.34), at the probes that found them -----------

def _probe_scores(n=30):
    rng = np.random.RandomState(0)
    return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)


NONFINITE = {"nan": np.nan, "posinf": np.inf, "neginf": -np.inf}
#: C.27: the JAX package's calibration errors of the ROADMAP probe (30
#: scores), whichever non-finite score is planted: it lies in no bin and
#: still counts in N (the sweep holds the same live at 24 scores)
CALIBRATION_PROBE = {"l1": 0.451673, "l2": 0.534918, "max": 0.979782}


@pytest.mark.parametrize("norm", sorted(CALIBRATION_PROBE))
@pytest.mark.parametrize("value", sorted(NONFINITE))
def test_c27_calibration_error_of_a_nonfinite_binary_score(value, norm):
    scores, target = _probe_scores()
    scores[2] = NONFINITE[value]
    got = port_f.calibration_error(torch.from_numpy(scores), torch.from_numpy(target), norm=norm)
    np.testing.assert_allclose(float(got), CALIBRATION_PROBE[norm], atol=1e-6)
    m = port.CalibrationError(norm=norm, device="cpu")
    m.update(torch.from_numpy(scores[:15]), torch.from_numpy(target[:15]))
    m.update(torch.from_numpy(scores[15:]), torch.from_numpy(target[15:]))
    np.testing.assert_allclose(float(m.compute()), CALIBRATION_PROBE[norm], atol=1e-6)


@pytest.mark.parametrize("value", sorted(NONFINITE))
def test_c27_calibration_error_of_a_nonfinite_multiclass_row(value):
    rng = np.random.RandomState(3)
    probs, target = _softmax(rng.randn(30, 4)), rng.randint(0, 4, 30)
    probs[2, 1] = NONFINITE[value]
    for norm in sorted(CALIBRATION_PROBE):
        m_ref = ref.CalibrationError(norm=norm)
        got = port.CalibrationError(norm=norm, device="cpu")
        m_ref.update(jnp.asarray(probs), jnp.asarray(target))
        got.update(torch.from_numpy(probs), torch.from_numpy(target))
        want = float(m_ref.compute())
        assert np.isfinite(want), norm
        np.testing.assert_allclose(float(got.compute()), want, rtol=1e-6, err_msg=norm)
        np.testing.assert_allclose(
            float(port_f.calibration_error(torch.from_numpy(probs), torch.from_numpy(target), norm=norm)),
            want, rtol=1e-6, err_msg=norm)


#: C.28: an integer target of the zero-mean audio metrics, each form
ZERO_MEAN_FORMS = {
    "si_snr": lambda pkg_f, p, t: pkg_f.si_snr(p, t),
    "si_sdr": lambda pkg_f, p, t: pkg_f.si_sdr(p, t, zero_mean=True),
    "snr": lambda pkg_f, p, t: pkg_f.snr(p, t, zero_mean=True),
    "SI_SNR": lambda pkg, p, t, **kw: _updated(pkg.SI_SNR(**kw), p, t),
    "SI_SDR": lambda pkg, p, t, **kw: _updated(pkg.SI_SDR(zero_mean=True, **kw), p, t),
}


def _updated(m, preds, target):
    m.update(preds, target)
    return m.compute()


@pytest.mark.parametrize("form", sorted(ZERO_MEAN_FORMS))
def test_c28_zero_mean_audio_of_an_integer_target(form):
    scores, target = _probe_scores(24)
    fn = ZERO_MEAN_FORMS[form]
    if form[0].isupper():
        want = fn(ref, jnp.asarray(scores), jnp.asarray(target))
        got = fn(port, torch.from_numpy(scores), torch.from_numpy(target), device="cpu")
    else:
        want = fn(ref_f, jnp.asarray(scores), jnp.asarray(target))
        got = fn(port_f, torch.from_numpy(scores), torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    if form in ("si_snr", "SI_SNR", "si_sdr", "SI_SDR"):
        np.testing.assert_allclose(float(got), -8.3225, atol=5e-5)


@pytest.mark.parametrize("half", ("float16",))  # bfloat16: the slow grid
def test_c29_mape_of_half_preds_and_an_integer_target_keeps_the_half_width(half):
    scores, target = _probe_scores(24)
    p_ref, p_port = jnp.asarray(scores).astype(getattr(jnp, half)), torch.from_numpy(scores).to(getattr(torch, half))
    want = ref_f.mean_absolute_percentage_error(p_ref, jnp.asarray(target))
    got = port_f.mean_absolute_percentage_error(p_port, torch.from_numpy(target))
    assert got.dtype == getattr(torch, half) and str(want.dtype) == half
    np.testing.assert_allclose(float(got), float(want), rtol=2 * float(torch.finfo(got.dtype).eps))
    if half == "float16":  # the sum overflows in half, in both packages
        assert float(got) == float("inf") == float(want)
    m_ref, m_port = ref.MeanAbsolutePercentageError(), port.MeanAbsolutePercentageError(device="cpu")
    for p_r, p_p, t in ((p_ref, p_port, target), (p_ref[::-1], p_port.flip(0), target[::-1].copy())):
        m_ref.update(p_r, jnp.asarray(t))
        m_port.update(p_p, torch.from_numpy(t))
    assert str(m_ref.compute().dtype) == str(m_port.compute().dtype).replace("torch.", "")  # float32 states
    eps = float(torch.finfo(got.dtype).eps)
    np.testing.assert_allclose(float(m_port.compute()), float(m_ref.compute()), rtol=2 * eps)


def test_c30_spearman_of_empty_inputs_is_nan():
    empty = np.zeros(0, np.float32)
    want = ref_f.spearman_corrcoef(jnp.asarray(empty), jnp.asarray(empty))
    got = port_f.spearman_corrcoef(torch.from_numpy(empty), torch.from_numpy(empty))
    assert np.isnan(float(want)) and torch.isnan(got)
    m = port.SpearmanCorrcoef(device="cpu")
    m.update(torch.from_numpy(empty), torch.from_numpy(empty))
    assert torch.isnan(m.compute())


@pytest.mark.parametrize("half", ("float16",))  # bfloat16: the slow grid
@pytest.mark.parametrize("name", ("snr", "si_sdr"))
def test_c31_signal_ratio_of_half_preds_and_an_integer_target_keeps_the_half_width(name, half):
    scores, target = _probe_scores(24)
    want = getattr(ref_f, name)(jnp.asarray(scores).astype(getattr(jnp, half)), jnp.asarray(target))
    got = getattr(port_f, name)(torch.from_numpy(scores).to(getattr(torch, half)), torch.from_numpy(target))
    assert got.dtype == getattr(torch, half) and str(want.dtype) == half
    np.testing.assert_allclose(float(got), float(want), rtol=2 * float(torch.finfo(got.dtype).eps))


def test_c32_pit_permutate_takes_indices_as_take_along_axis_does():
    rng = np.random.RandomState(0)
    preds = rng.randn(2, 3, 5).astype(np.float32)
    perm = np.array([[-1, 0, 1], [2, -3, -2]])
    want = ref_f.pit_permutate(jnp.asarray(preds), jnp.asarray(perm))
    got = port_f.pit_permutate(torch.from_numpy(preds), torch.from_numpy(perm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="integer type"):
        ref_f.pit_permutate(jnp.asarray(preds), jnp.asarray(perm, jnp.float32))
    with pytest.raises(TypeError, match="integer type"):
        port_f.pit_permutate(torch.from_numpy(preds), torch.from_numpy(perm).float())


@pytest.mark.parametrize("half", ("float16",))  # bfloat16: the slow grid
def test_c34_pearson_of_half_preds_and_an_integer_target_takes_the_jax_widths(half):
    """An integer target against the half moments of the functional: the
    JAX package sums the co-moment in the half dtype, not in float32."""
    scores, target = _probe_scores(24)
    want = ref_f.pearson_corrcoef(jnp.asarray(scores).astype(getattr(jnp, half)), jnp.asarray(target))
    got = port_f.pearson_corrcoef(torch.from_numpy(scores).to(getattr(torch, half)), torch.from_numpy(target))
    _assert_same(want, got, half, half)


def test_c33_bleu_refuses_tensor_tokens_as_the_reference_does():
    tokens = np.arange(12).reshape(2, 1, 6)
    with pytest.raises(TypeError, match="unhashable"):
        ref_f.bleu_score(jnp.asarray(tokens), jnp.asarray(tokens[:, 0]))
    with pytest.raises(TypeError, match="unhashable"):
        port_f.bleu_score(torch.from_numpy(tokens), torch.from_numpy(tokens[:, 0]))
    with pytest.raises(TypeError, match="unhashable"):
        port.BLEUScore(device="cpu").update([[list(torch.arange(3))]], [list(torch.arange(3))])
    assert float(port_f.bleu_score([[["a", "b"]]], [["a", "b"]], n_gram=2)) == 1.0
