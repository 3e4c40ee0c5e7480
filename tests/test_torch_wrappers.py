"""The port's wrappers and ``embedding_similarity`` against the JAX package.

Case for case with ``tests/wrappers/test_wrappers.py`` and
``tests/wrappers/test_bootstrap_parity.py``, on the CPU:

- one seed resamples the same rows in both packages (Poisson counts and
  randint draws of ``jax.random``), and the copies' raw values and their
  mean, std and quantiles agree, on MSE and micro Precision and Recall. The
  raw values are float32 reductions of the same rows, so they are held to
  ``VALUE_RTOL`` (a few ulps); the summary statistics of ``COPIES`` values
  to the same bar;
- the wrapper's ``state_dict()`` holds the JAX package's keys (none: the
  copies are not state), and ``.to()`` moves the copies and the key;
- MetricTracker's best value, its step and its exceptions;
- ``embedding_similarity`` over dot/cosine x none/sum/mean x zero_diagonal,
  within a bound derived from the float32 products (``_similarity_bound``).

The JAX BootStrapper compiles its metric's update once per resample length,
so the JAX references run once per module (``reference``) at a small batch,
where Poisson lengths repeat.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import mean_squared_error, precision_score, recall_score

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu.functional.self_supervised import embedding_similarity as ref_embedding_similarity
from metrics_tpu.wrappers.bootstrapping import _bootstrap_sampler as ref_sampler
from metrics_tpu_torch.functional import embedding_similarity
from metrics_tpu_torch.ops import prng
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper, _bootstrap_sampler

NUM_BATCHES, BATCH, COPIES, SEED = 2, 8, 2, 7
VALUE_RTOL = 4 * 2.0**-24
_rng = np.random.RandomState(42)
PREDS_CLS = _rng.randint(0, 10, (NUM_BATCHES, BATCH))
# right on about 60% of the rows, so that resamples differ in value
TARGET_CLS = np.where(_rng.rand(NUM_BATCHES, BATCH) < 0.6, PREDS_CLS, _rng.randint(0, 10, (NUM_BATCHES, BATCH)))
PREDS_REG = _rng.rand(NUM_BATCHES, BATCH).astype(np.float32)
TARGET_REG = _rng.rand(NUM_BATCHES, BATCH).astype(np.float32)
QUANTILES = [0.05, 0.95]

CASES = {
    "precision_micro": (lambda pkg, **kw: pkg.Precision(num_classes=10, average="micro", **kw),
                        partial(precision_score, average="micro"), PREDS_CLS, TARGET_CLS),
    "recall_micro": (lambda pkg, **kw: pkg.Recall(num_classes=10, average="micro", **kw),
                     partial(recall_score, average="micro"), PREDS_CLS, TARGET_CLS),
    "mse": (lambda pkg, **kw: pkg.MeanSquaredError(**kw), mean_squared_error, PREDS_REG, TARGET_REG),
}
STRATEGIES = ("poisson", "multinomial")


class _CapturingBootStrapper(BootStrapper):
    """Keeps the resample indices of every copy at every update."""

    def update(self, *args):
        self.out = []
        size = len(args[0])
        for idx in range(self.num_bootstraps):
            keys = prng.split(self._key)
            self._key, subkey = keys[0], keys[1]
            sample_idx = _bootstrap_sampler(subkey, size, sampling_strategy=self.sampling_strategy)
            self.metrics[idx].update(*apply_to_collection(args, torch.Tensor, lambda x: x.index_select(0, sample_idx)))
            self.out.append(sample_idx)


def _boot(pkg, name, strategy, **kw):
    make = CASES[name][0]
    wrapper = ref.BootStrapper if pkg is ref else BootStrapper
    return wrapper(make(pkg, **kw), num_bootstraps=COPIES, mean=True, std=True, raw=True,
                   quantile=QUANTILES if pkg is port else jnp.asarray(QUANTILES), sampling_strategy=strategy,
                   seed=SEED)


class _RefCapturingBootStrapper(ref.BootStrapper):
    """The JAX package's BootStrapper, keeping each copy's resample indices
    (the JAX suite's ``_CapturingBootStrapper``)."""

    def update(self, *args):
        self.out = []
        for idx in range(self.num_bootstraps):
            self._key, subkey = jax.random.split(self._key)
            sample_idx = ref_sampler(subkey, len(args[0]), sampling_strategy=self.sampling_strategy)
            self.metrics[idx].update(*(jnp.take(x, sample_idx, axis=0) for x in args))
            self.out.append(np.asarray(sample_idx))


@pytest.fixture(scope="module")
def reference():
    """Per (metric, strategy): the JAX package's resample indices of each
    copy at each update and its BootStrapper's outputs."""
    out = {}
    for name, (make, _sk, preds, target) in CASES.items():
        for strategy in STRATEGIES:
            boot = _RefCapturingBootStrapper(make(ref), num_bootstraps=COPIES, raw=True,
                                             quantile=jnp.asarray(QUANTILES), sampling_strategy=strategy, seed=SEED)
            indices = []
            for p, t in zip(preds, target):
                boot.update(jnp.asarray(p), jnp.asarray(t))
                indices.append(boot.out)
            values = {k: np.asarray(v) for k, v in boot.compute().items()}
            out[(name, strategy)] = (indices, values, sorted(boot.state_dict()))
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", list(CASES))
def test_bootstrap_resamples_and_values_match_the_reference(reference, name, strategy):
    """One seed: the same rows resampled into each copy at each update, and
    the same raw/mean/std/quantile; each copy's value is sklearn's on its
    own resampled stream (the JAX suite's per-copy check)."""
    want_idx, want, want_keys = reference[(name, strategy)]
    _make, sk_metric, preds, target = CASES[name]
    boot = _CapturingBootStrapper(CASES[name][0](port, device="cpu"), num_bootstraps=COPIES, raw=True,
                                  quantile=QUANTILES, sampling_strategy=strategy, seed=SEED)
    streams = [([], []) for _ in range(COPIES)]
    for step, (p, t) in enumerate(zip(preds, target)):
        boot.update(torch.from_numpy(p), torch.from_numpy(t))
        for i, idx in enumerate(boot.out):
            assert np.array_equal(idx.numpy(), want_idx[step][i]), f"copy {i} at update {step}: other rows"
            streams[i][0].append(p[idx.numpy()])
            streams[i][1].append(t[idx.numpy()])
    got = {k: v.numpy() for k, v in boot.compute().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=VALUE_RTOL, atol=VALUE_RTOL, err_msg=k)
    sk = [sk_metric(np.concatenate(ts), np.concatenate(ps)) for ps, ts in streams]
    np.testing.assert_allclose(got["raw"], sk, atol=1e-5)
    assert sorted(boot.state_dict()) == want_keys
    plain = _boot(port, name, strategy, device="cpu")  # the wrapper's own update
    for p, t in zip(preds, target):
        plain.update(torch.from_numpy(p), torch.from_numpy(t))
    for k, v in plain.compute().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=VALUE_RTOL, atol=VALUE_RTOL, err_msg=k)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_bootstrapper_update_equals_one_copy_at_a_time(strategy):
    """The batched sampler (one Poisson loop for every copy) gives each copy
    the rows that its own key alone gives."""
    a = _boot(port, "mse", strategy, device="cpu")
    b = _CapturingBootStrapper(port.MeanSquaredError(device="cpu"), num_bootstraps=COPIES, sampling_strategy=strategy,
                               seed=SEED)
    for p, t in zip(PREDS_REG, TARGET_REG):
        a.update(torch.from_numpy(p), torch.from_numpy(t))
        b.update(torch.from_numpy(p), torch.from_numpy(t))
    for ma, mb in zip(a.metrics, b.metrics):
        assert torch.equal(ma.sum_squared_error, mb.sum_squared_error) and torch.equal(ma.total, mb.total)
    assert torch.equal(a._key, b._key)


def test_bootstrapper_copies_are_not_state_and_move_with_to():
    boot = BootStrapper(port.MeanSquaredError(device="cpu"), num_bootstraps=3)
    assert boot.state_dict() == {} and list(boot.children()) == []
    assert boot.state_fingerprint() == ()
    boot.update(torch.rand(8), torch.rand(8))
    boot.to("meta")
    assert boot.device.type == "meta" and boot._key.device.type == "meta" and boot._key.dtype == torch.int64
    assert all(m.device.type == "meta" and m.sum_squared_error.device.type == "meta" for m in boot.metrics)


def test_bootstrapper_follows_the_base_metric_device():
    assert BootStrapper(port.MeanSquaredError(device="cpu")).device == torch.device("cpu")
    assert port.MetricTracker(port.MeanSquaredError(device="cpu")).device == torch.device("cpu")


# ---- tests/wrappers/test_wrappers.py, case for case -----------------------


def test_average_meter_simple():
    avg = port.AverageMeter(device="cpu")
    avg.update(3)
    avg.update(1)
    np.testing.assert_allclose(avg.compute().numpy(), 2.0)


def test_average_meter_weighted():
    avg = port.AverageMeter(device="cpu")
    np.testing.assert_allclose(avg(torch.tensor([1.0, 2.0]), torch.tensor([3.0, 1.0])).numpy(), 1.25)


def test_average_meter_vector():
    avg = port.AverageMeter(device="cpu")
    np.testing.assert_allclose(avg(torch.tensor([1.0, 2.0, 3.0])).numpy(), 2.0)


def test_bootstrapper_accuracy():
    rng = np.random.RandomState(123)
    boot = BootStrapper(port.Accuracy(num_classes=5, device="cpu"), num_bootstraps=20, seed=1)
    boot.update(torch.from_numpy(rng.randint(0, 5, (200,))), torch.from_numpy(rng.randint(0, 5, (200,))))
    out = boot.compute()
    assert set(out.keys()) == {"mean", "std"}
    assert abs(float(out["mean"]) - 0.2) < 0.1
    assert float(out["std"]) > 0


def test_bootstrapper_quantile_raw():
    rng = np.random.RandomState(5)
    boot = BootStrapper(port.Accuracy(num_classes=5, device="cpu"), num_bootstraps=10, quantile=0.5, raw=True,
                        sampling_strategy="multinomial")
    boot.update(torch.from_numpy(rng.randint(0, 5, (100,))), torch.from_numpy(rng.randint(0, 5, (100,))))
    out = boot.compute()
    assert "quantile" in out and "raw" in out
    assert out["raw"].shape == (10,)


def test_bootstrapper_invalid():
    with pytest.raises(ValueError, match="Expected base metric"):
        BootStrapper("not-a-metric")
    with pytest.raises(ValueError, match="sampling_strategy"):
        BootStrapper(port.Accuracy(device="cpu"), sampling_strategy="bogus")
    with pytest.raises(ValueError, match="None of the input contained tensors"):
        BootStrapper(port.MeanSquaredError(device="cpu")).update()


class _Sum(port.Metric):
    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


class _RefSum(ref.Metric):
    def __init__(self):
        super().__init__()
        self.add_state("x", jnp.asarray(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


@pytest.mark.parametrize("maximize, vals", [(True, [1.0, 5.0, 3.0]), (False, [3.0, 1.0, 2.0]), (True, [2.0, 2.0, 1.0])])
def test_tracker_best_value_and_step_match_the_reference(maximize, vals):
    got, want = port.MetricTracker(_Sum(), maximize=maximize), ref.MetricTracker(_RefSum(), maximize=maximize)
    for v in vals:
        got.increment()
        want.increment()
        got.update(torch.tensor(v))
        want.update(jnp.asarray(v))
    np.testing.assert_allclose(got.compute_all().numpy(), np.asarray(want.compute_all()))
    assert got.best_metric(return_step=True) == want.best_metric(return_step=True)
    assert got.best_metric() == want.best_metric()
    assert got.n_steps == want.n_steps == len(vals)


def test_tracker_lifecycle():
    tracker = port.MetricTracker(_Sum(), maximize=True)
    with pytest.raises(ValueError, match="cannot be called before"):
        tracker.update(torch.tensor(1.0))
    vals = [1.0, 5.0, 3.0]
    for v in vals:
        tracker.increment()
        tracker.update(torch.tensor(v))
    np.testing.assert_allclose(tracker.compute_all().numpy(), vals)
    best, step = tracker.best_metric(return_step=True)
    assert best == 5.0 and step == 1
    assert tracker.n_steps == 3


def test_tracker_minimize():
    tracker = port.MetricTracker(_Sum(), maximize=False)
    for v in [3.0, 1.0, 2.0]:
        tracker.increment()
        tracker.update(torch.tensor(v))
    assert tracker.best_metric() == 1.0


@pytest.mark.parametrize("sampling_strategy", STRATEGIES)
def test_bootstrap_sampler_resamples_with_replacement(sampling_strategy):
    idx = _bootstrap_sampler(prng.prng_key(7), BATCH, sampling_strategy=sampling_strategy).numpy()
    assert idx.min() >= 0 and idx.max() < BATCH
    counts = np.bincount(idx, minlength=BATCH)
    assert counts.max() >= 2, "no row sampled twice: not with replacement"
    assert (counts == 0).any(), "every row sampled: not a bootstrap draw"
    assert np.array_equal(idx, np.asarray(ref_sampler(jax.random.PRNGKey(7), BATCH, sampling_strategy=sampling_strategy)))
    with pytest.raises(ValueError, match="Unknown sampling strategy"):
        _bootstrap_sampler(prng.prng_key(7), BATCH, sampling_strategy="bogus")


@pytest.mark.parametrize("data", ["cls", "reg"])
def test_bootstrap_mean_tracks_full_data_value(data):
    rng = np.random.RandomState(42)
    if data == "cls":
        make = lambda: port.Accuracy(num_classes=4, device="cpu")  # noqa: E731
        a, b = (torch.from_numpy(rng.randint(0, 4, (400,))) for _ in range(2))
    else:
        make = lambda: port.MeanSquaredError(device="cpu")  # noqa: E731
        a, b = (torch.from_numpy(rng.randn(400).astype(np.float32)) for _ in range(2))
    base = make()
    base.update(a, b)
    full = float(base.compute())
    boot = BootStrapper(make(), num_bootstraps=50, seed=3)
    boot.update(a, b)
    out = boot.compute()
    assert abs(float(out["mean"]) - full) < 0.15 * max(abs(full), 0.1)
    assert 0 < float(out["std"]) < max(abs(full), 0.5)


def test_tracker_wrong_input_raises():
    with pytest.raises(TypeError, match="instance of a metrics_tpu_torch metric"):
        port.MetricTracker([1, 2, 3])
    with pytest.raises(TypeError):
        ref.MetricTracker([1, 2, 3])


@pytest.mark.parametrize("method, args", [("update", (1.0,)), ("forward", (1.0,)), ("compute", ())])
def test_tracker_all_methods_require_increment(method, args):
    for tracker, conv in ((port.MetricTracker(_Sum()), torch.tensor), (ref.MetricTracker(_RefSum()), jnp.asarray)):
        with pytest.raises(ValueError, match=f"`{method}` cannot be called before"):
            getattr(tracker, method)(*(conv(a) for a in args))


def test_tracker_update_and_forward_interleaved():
    tracker = port.MetricTracker(port.MeanSquaredError(device="cpu"), maximize=False)
    rng = np.random.RandomState(1)
    for i in range(3):
        tracker.increment()
        for _ in range(2):
            tracker.update(torch.from_numpy(rng.randn(20)), torch.from_numpy(rng.randn(20)))
        for _ in range(2):
            tracker(torch.from_numpy(rng.randn(20)), torch.from_numpy(rng.randn(20)))
        assert float(tracker.compute()) > 0
        assert tracker.n_steps == i + 1
    assert tracker.compute_all().shape[0] == 3
    best, idx = tracker.best_metric(return_step=True)
    assert best > 0 and idx in range(3)


# ---- embedding_similarity ---------------------------------------------------

EMB = np.random.RandomState(3).randn(16, 8).astype(np.float32)
EMB[5] = EMB[2]  # an identical pair


def _similarity_bound(x, similarity, reduction):
    """Float32 error of a row of products: each of the D terms and their sum
    round once (2·D ulps of Σ|x_i x_j|), the cosine normalisation adds a few
    more, and a sum/mean over B entries adds log2(B) roundings of its
    magnitude."""
    x = x.astype(np.float64)
    if similarity == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    mag = np.abs(x) @ np.abs(x).T
    d, b = x.shape[1], x.shape[0]
    ulps = 2 * d + (6 if similarity == "cosine" else 0)
    if reduction == "none":
        return ulps * 2.0**-24 * mag.max()
    return (ulps + np.log2(b)) * 2.0**-24 * mag.sum(axis=1).max()


@pytest.mark.parametrize("zero_diagonal", [True, False])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_embedding_similarity_matches_the_reference(similarity, reduction, zero_diagonal):
    want = np.asarray(ref_embedding_similarity(jnp.asarray(EMB), similarity, reduction, zero_diagonal))
    got = embedding_similarity(torch.from_numpy(EMB), similarity, reduction, zero_diagonal)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_similarity_bound(EMB, similarity, reduction))
    if reduction == "none":
        diag = np.diagonal(got.numpy())
        if zero_diagonal:
            assert np.all(diag == 0)
        elif similarity == "cosine":
            np.testing.assert_allclose(diag, 1.0, atol=4 * 2.0**-24 * 8)


def test_embedding_similarity_is_full_float32_whatever_the_tf32_flag():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = embedding_similarity(torch.from_numpy(EMB), "dot")
        assert torch.backends.cuda.matmul.allow_tf32 is True  # the caller's flag is restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(got, embedding_similarity(torch.from_numpy(EMB), "dot"))
