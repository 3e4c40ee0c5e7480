"""The metric runtime's slice-3 surface in the port against the JAX package:
``set_dtype`` and ``half``/``float``/``double``/``type`` with their
persistence across updates, the operator overloads and
``CompositionalMetric``, identity hashing, and state carried across from the
JAX package (float16 included).

Float values compare at atol=1e-6 (float16 states hold small counts, exact in
both). The JAX package without x64 truncates float64 to float32; the port
keeps float64, so values are compared, not dtypes.
"""
import operator
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
import metrics_tpu_torch as port
from metrics_tpu_torch.utils.convert import state_dict_from_reference

ATOL = 1e-6
N = C = 10


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0, atol=ATOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def _batches(kind="probs", seeds=(0, 1)):
    out = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        if kind == "binary":
            out.append((rng.rand(N).astype(np.float32), rng.randint(0, 2, N)))
        else:
            out.append((rng.rand(N, C).astype(np.float32), rng.randint(0, C, N)))
    return out


def _torch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _jax(batch):
    return tuple(jnp.asarray(a) for a in batch)


# ---------------------------------------------------------------------------
# set_dtype and its aliases
# ---------------------------------------------------------------------------

CASTS = {
    "half": (lambda m: m.half(), lambda m: m.half(), torch.float16),
    "float": (lambda m: m.float(), lambda m: m.float(), torch.float32),
    "double": (lambda m: m.double(), lambda m: m.double(), torch.float64),
    "set_dtype": (lambda m: m.set_dtype(torch.float16), lambda m: m.set_dtype(jnp.float16), torch.float16),
    "type": (lambda m: m.type(torch.float16), lambda m: m.type(jnp.float16), torch.float16),
}


@pytest.mark.filterwarnings("ignore:Explicitly requested dtype float64")
@pytest.mark.parametrize("cast", sorted(CASTS))
def test_set_dtype_persists_across_updates(cast):
    to_port, to_ref, dtype = CASTS[cast]
    # MatthewsCorrcoef's confusion matrix is a float32 state, as in the JAX package
    m_port = to_port(port.MatthewsCorrcoef(C, device="cpu"))
    m_ref = to_ref(ref.MatthewsCorrcoef(C))
    assert m_port.confmat.dtype == m_port._defaults["confmat"].dtype == dtype
    for batch in _batches():
        # the float32 batch count would promote a half state back without the re-cast
        m_port.update(*_torch(batch))
        m_ref.update(*_jax(batch))
        assert m_port.confmat.dtype == dtype
    _assert_close(m_port.confmat, m_ref.confmat)
    _assert_close(m_port.compute(), m_ref.compute())
    m_port.reset()
    assert m_port.confmat.dtype == dtype


def test_set_dtype_leaves_integer_states_and_reaches_nested_metrics():
    mc = port.MetricCollection({
        "stats": port.StatScores(reduce="macro", num_classes=C, device="cpu"),
        "mcc": port.MatthewsCorrcoef(C, device="cpu"),
    })
    mc.half()  # nn.Module.half of the collection reaches each member's _apply
    for batch in _batches():
        mc(*_torch(batch))
    assert mc["stats"].tp.dtype == torch.int64
    assert mc["mcc"].confmat.dtype == torch.float16
    mc.to(torch.float64)
    mc.update(*_torch(_batches(seeds=(2,))[0]))
    assert mc["mcc"].confmat.dtype == mc["mcc"]._defaults["confmat"].dtype == torch.float64
    # a move to another device is not a cast, and records nothing
    mc.to("cpu")
    assert mc["mcc"]._dtype == torch.float64


def test_state_carried_from_reference_keeps_float16():
    m_ref = ref.MatthewsCorrcoef(C).set_dtype(jnp.float16)
    for batch in _batches():
        m_ref.update(*_jax(batch))
    m_ref.persistent(True)
    sd = state_dict_from_reference(m_ref.state_dict(), device="cpu")
    assert sd["confmat"].dtype == torch.float16
    m_port = port.MatthewsCorrcoef(C, device="cpu").half()
    m_port.load_state_dict(sd, strict=True)
    _assert_close(m_port.confmat, m_ref.confmat)
    _assert_close(m_port.compute(), m_ref.compute())


@pytest.mark.parametrize("cls,kwargs", [
    ("ConfusionMatrix", dict(num_classes=C, normalize="true")),
    ("IoU", dict(num_classes=C, ignore_index=1)),
    ("Precision", dict(num_classes=C, average="macro")),
], ids=["ConfusionMatrix", "IoU", "Precision"])
def test_state_carried_from_reference(cls, kwargs):
    m_ref = getattr(ref, cls)(**kwargs)
    for batch in _batches():
        m_ref.update(*_jax(batch))
    m_ref.persistent(True)
    m_port = getattr(port, cls)(device="cpu", **kwargs)
    m_port.load_state_dict(state_dict_from_reference(m_ref.state_dict(), device="cpu"), strict=True)
    for name in m_ref._defaults:
        assert m_port._state[name].dtype == torch.int64
        _assert_close(m_port._state[name], m_ref._state[name])
    _assert_close(m_port.compute(), m_ref.compute())


# ---------------------------------------------------------------------------
# operators and CompositionalMetric
# ---------------------------------------------------------------------------


def _scores(pkg, **kw):
    """Two metrics with float scalar values."""
    return pkg.Precision(**kw), pkg.Recall(**kw)


def _counts(pkg, **kw):
    """Two metrics with int vector values ([tp, fp, tn, fn, support])."""
    return pkg.StatScores(reduce="micro", **kw), pkg.StatScores(reduce="micro", threshold=0.3, **kw)


OPERATORS = {
    "add": (_scores, operator.add), "sub": (_scores, operator.sub), "mul": (_scores, operator.mul),
    "truediv": (_scores, operator.truediv), "pow": (_scores, operator.pow),
    # integer division by zero raises in torch; the JAX package returns a value
    "floordiv": (_counts, lambda a, b: a // (b + 1)), "mod": (_counts, lambda a, b: a % (b + 1)),
    "matmul": (_counts, operator.matmul),
    "and": (_counts, operator.and_), "or": (_counts, operator.or_), "xor": (_counts, operator.xor),
    "eq": (_counts, operator.eq), "ne": (_counts, operator.ne), "lt": (_counts, operator.lt),
    "le": (_counts, operator.le), "gt": (_counts, operator.gt), "ge": (_counts, operator.ge),
    "radd": (_scores, lambda a, b: 2 + a), "rsub": (_scores, lambda a, b: 1 - a),
    "rmul": (_scores, lambda a, b: 2 * a), "rtruediv": (_scores, lambda a, b: 1 / a),
    "rpow": (_scores, lambda a, b: 2 ** a), "rfloordiv": (_counts, lambda a, b: 7 // (a + 1)),
    "rmod": (_counts, lambda a, b: 7 % (a + 1)), "rand": (_counts, lambda a, b: 6 & a),
    "ror": (_counts, lambda a, b: 6 | a), "rxor": (_counts, lambda a, b: 6 ^ a),
    "abs": (_scores, lambda a, b: abs(a - b)), "neg": (_scores, lambda a, b: -a),
    # unary plus is abs, not identity, as in the JAX package
    "pos": (_scores, lambda a, b: +(a - 1)),
    "invert": (_counts, lambda a, b: ~a), "getitem": (_counts, lambda a, b: a[1]),
    "f1": (_scores, lambda a, b: 2 * (a * b) / (a + b)),
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_matches_reference(name):
    make, op = OPERATORS[name]
    comp_port, comp_ref = op(*make(port, device="cpu")), op(*make(ref))
    assert isinstance(comp_port, port.CompositionalMetric)
    kind = "binary"
    for batch in _batches(kind):
        _assert_close(comp_port(*_torch(batch)), comp_ref(*_jax(batch)))
    _assert_close(comp_port.compute(), comp_ref.compute())


def test_rmatmul_with_a_constant_vector():
    a_port, _ = _counts(port, device="cpu")
    a_ref, _ = _counts(ref)
    comp_port, comp_ref = torch.ones(5, dtype=torch.long) @ a_port, jnp.ones(5, dtype=jnp.int32) @ a_ref
    assert isinstance(comp_port, port.CompositionalMetric)
    for batch in _batches("binary"):
        comp_port.update(*_torch(batch))
        comp_ref.update(*_jax(batch))
    _assert_close(comp_port.compute(), comp_ref.compute())


def test_composite_reset_and_pickle():
    p, r = _scores(port, device="cpu")
    f1, first = 2 * (p * r) / (p + r), p[...]
    batches = _batches("binary")
    for batch in batches:
        f1(*_torch(batch))
        first.update(*_torch(batch))
    value = f1.compute()
    for copy in (pickle.loads(pickle.dumps(f1)), f1.clone()):
        assert torch.equal(copy.compute(), value)
    assert torch.equal(pickle.loads(pickle.dumps(first)).compute(), first.compute())
    f1.reset()
    assert f1._computed is None and not f1._update_called
    assert int(p.tp) == 0 and int(r.tp) == 0
    for batch in batches:
        f1.update(*_torch(batch))
    assert torch.equal(f1.compute(), value)


def test_composite_takes_its_operands_device():
    p, r = _scores(port, device="cpu")
    comp = (p + r) * 2.5
    assert comp.device == torch.device("cpu")
    assert comp.metric_b.device == torch.device("cpu") and comp.metric_b.dtype == torch.float32
    moved = comp.to("meta")
    assert moved.device == p.device == torch.device("meta")
    assert moved.metric_b.device == torch.device("meta")
    with pytest.raises(ValueError, match="different devices"):
        port.Precision(device="cpu") + port.Recall(device="meta")


def test_metrics_hash_by_identity():
    a, b = port.MatthewsCorrcoef(C, device="cpu"), port.MatthewsCorrcoef(C, device="cpu")
    assert isinstance(a == b, port.CompositionalMetric)
    assert len({a, b}) == 2 and hash(a) != hash(b)
    # equal states (both fresh): a state-bytes hash would let the module tree
    # take them for one module, and .to() would cast only the first
    mc = port.MetricCollection({"a": a, "b": b})
    assert len(list(mc.children())) == 2
    mc.to(torch.float64)
    assert a.confmat.dtype == b.confmat.dtype == torch.float64
