"""The port's examples (``examples/torch_*.py``) against the JAX package's
(``examples/*.py``), on the CPU, in process.

- Train loop: the MLP starts from the JAX example's ``init_params(PRNGKey(0))``
  within 4 ulps (``ops/prng.py``'s ``normal`` against XLA's ``ErfInv``,
  ROADMAP C.14); each epoch's loss within ``LOSS_RTOL = 1e-4`` of the JAX
  example's ``run_training()`` (``torch.optim.Adam`` and ``optax.adam``
  round their updates differently, and 16 steps carry it; seen 2.4e-6), its
  accuracies within one sample of the epoch's ``steps * batch``; and the
  JAX tests' two behaviours (``tests/integrations/test_train_loop.py``).
- Sharded eval: the per-rank body on two thread ranks
  (``tests/helpers/torch_world.py``) syncing through ``pure_sync``, equal to
  the JAX example's single-device reference within its ``1e-6``.
- Own-model BERTScore: equal to the JAX example's ``compute()`` within
  ``BERT_ATOL = 1e-5`` (float32 attention over 6 tokens of width 4; seen
  1.5e-8).

Each JAX reference is built once per module.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu_torch.ops import prng
from tests.helpers.torch_world import TorchLockstepWorld
from tests.helpers.ulps import max_ulps

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
LOSS_RTOL = 1e-4
BERT_ATOL = 1e-5
EPOCHS, STEPS, BATCH = 2, 8, 64


def _load(filename):
    """An example module by its file path (``bert_score-own_model.py`` is no
    module name); the JAX examples import ``_cpu_default`` beside them."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    name = "example_" + filename[:-3].replace("-", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, EXAMPLES / filename)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train():
    return _load("torch_train_loop_integration.py")


@pytest.fixture(scope="module")
def jax_train():
    return _load("train_loop_integration.py")


@pytest.fixture(scope="module")
def jax_history(jax_train):
    return jax_train.run_training(num_epochs=EPOCHS, steps_per_epoch=STEPS, batch_size=BATCH)


def test_train_loop_starts_from_the_reference_parameters(train, jax_train):
    got = train.init_params(prng.prng_key(0))
    want = jax_train.init_params(jax.random.PRNGKey(0))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        assert max_ulps(v, want[k]) <= 4, k
    model = train.Trainer(device="cpu").model
    assert all(torch.equal(getattr(model, k), v) for k, v in got.items())


def test_train_loop_epochs_match_the_reference(train, jax_history):
    history = train.run_training(num_epochs=EPOCHS, steps_per_epoch=STEPS, batch_size=BATCH, device="cpu")
    assert len(history) == len(jax_history) == EPOCHS
    one_sample = 1.0 / (STEPS * BATCH)
    for got, want in zip(history, jax_history):
        assert sorted(got) == sorted(want) == ["acc", "loss", "macro_acc"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        assert abs(got["acc"] - want["acc"]) <= one_sample
        assert abs(got["macro_acc"] - want["macro_acc"]) <= one_sample


def test_train_loop_metrics_improve_over_training(train):
    history = train.run_training(num_epochs=3, steps_per_epoch=10, batch_size=64, device="cpu")
    assert len(history) == 3
    # the task is learnable: accuracy must rise materially and loss must fall
    assert history[-1]["acc"] > history[0]["acc"] + 0.05
    assert history[-1]["loss"] < history[0]["loss"]
    # macro over balanced random classes tracks micro closely
    assert abs(history[-1]["acc"] - history[-1]["macro_acc"]) < 0.1


def test_train_loop_epoch_reset_isolates_epochs():
    """Epoch N's computed value reflects only epoch N's batches."""
    metrics = port.MetricCollection({"acc": port.Accuracy(num_classes=3, device="cpu")})
    preds = torch.from_numpy(np.eye(3)[np.zeros(30, dtype=int)].astype(np.float32))
    state = metrics.pure_update(metrics.init_state(), preds, torch.ones(30, dtype=torch.int64))
    assert float(metrics.pure_compute(state)["acc"]) == 0.0
    state = metrics.pure_update(metrics.init_state(), preds, torch.zeros(30, dtype=torch.int64))
    assert float(metrics.pure_compute(state)["acc"]) == 1.0


def test_train_loop_graph_needs_the_card(train):
    with pytest.raises(ValueError, match="CUDA graph"):
        train.Trainer(device="cpu", graph=True)


# ---------------------------------------------------------------------------
# the sharded eval
# ---------------------------------------------------------------------------

WORLD = 2


@pytest.fixture(scope="module")
def sharded():
    return _load("torch_sharded_eval.py")


@pytest.fixture(scope="module")
def jax_sharded_reference(sharded):
    """The JAX example's single-device reference over the same rows."""
    logits, target = sharded.eval_data(WORLD)
    m = ref.MetricCollection({"acc": ref.Accuracy(num_classes=2), "auroc": ref.AUROC(num_classes=2)})
    m.update(jax.nn.softmax(jnp.asarray(logits)), jnp.asarray(target))
    return {k: float(v) for k, v in m.compute().items()}


def test_sharded_eval_ranks_match_the_reference(sharded, jax_sharded_reference, monkeypatch):
    world = TorchLockstepWorld(WORLD).install(monkeypatch)
    try:
        per_rank = world.run(lambda rank: sharded.eval_rank(rank, WORLD, world.axis("world"), "cpu"))
    finally:
        world.shutdown_executors()
    assert world.calls > 0
    for values in per_rank:
        assert sorted(values) == ["acc", "auroc"]
        sharded.check(values, jax_sharded_reference)
    monkeypatch.undo()
    for k, v in sharded.reference(WORLD, "cpu").items():
        assert abs(v - jax_sharded_reference[k]) < sharded.ATOL, k


def test_sharded_eval_shards_are_the_reference_layout(sharded):
    logits, target = sharded.eval_data(WORLD)
    assert logits.shape == (WORLD * 512, 2) and target.shape == (WORLD * 512,)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(logits, rng.randn(WORLD * 512, 2).astype(np.float32))


# ---------------------------------------------------------------------------
# BERTScore with the user's model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bert():
    return _load("torch_bert_score_own_model.py")


@pytest.fixture(scope="module")
def jax_bert():
    return _load("bert_score-own_model.py")


def test_own_model_bertscore_matches_the_reference(bert, jax_bert):
    metric = ref.BERTScore(model=jax_bert.get_user_model_encoder(), user_tokenizer=jax_bert.UserTokenizer(),
                           user_forward_fn=jax_bert.user_forward_fn, max_length=jax_bert._MAX_LEN)
    metric.update(jax_bert._PREDS, jax_bert._REFS)
    want = metric.compute()
    got = bert.run("cpu")
    assert bert._PREDS == jax_bert._PREDS and bert._REFS == jax_bert._REFS
    for k in ("precision", "recall", "f1"):
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64), np.asarray(want[k], dtype=np.float64),
                                   atol=BERT_ATOL, rtol=0, err_msg=k)


def test_own_model_encoder_is_the_reference_draw(bert):
    key = jax.random.PRNGKey(42)
    model = bert.TinyEncoder(device="cpu")
    for qkv, ffn in zip(model.qkv, model.ffn):
        key, k1, k2 = jax.random.split(key, 3)
        assert max_ulps(qkv, jax.random.normal(k1, (4, 12)) * 0.3) <= 4
        assert max_ulps(ffn, jax.random.normal(k2, (4, 4)) * 0.3) <= 4
