"""The port's Inception-v3 (``metrics_tpu_torch/models/inception.py``)
against the JAX package's (``metrics_tpu/models/inception.py``), on the CPU.

The JAX params pytree (``inception_v3_init``) crosses with
``params_from_jax``; every tap of the fidelity forward is then held against
``inception_v3_apply`` on the same two images. Each parameter-free op of
both variants (the pools, the TF1 resize, the torchvision resize shrinking
and growing, the preprocessing) is held against its JAX helper, a
torchvision-layout state dict loads, and the extractor's checks and warnings
are the JAX package's. The JAX forward is built once per module (about 20 s
of compile on the CPU); the torchvision variant's whole net, a second such
compile, runs only under ``-m slow``.

Tolerances:

- taps ``TAP_RTOL = 1e-5`` of the tap's largest value: ~95 convolutions
  deep, each a float32 sum of up to 4,032 products, with batch norm folded
  into the weights here and applied after the convolution in the JAX
  package; the two sides were 1.8e-6 of the largest value apart at most
  (the ``2048`` tap).
- pools and the TF1 resize: ``OP_ATOL = 1e-5`` on inputs of size ≤ 255
  (the same float32 formula; XLA and torch may order a 9-term sum
  differently: 9 · 2**-24 · 255 = 1.4e-4 would be the worst, seen 0).
- torchvision resize ``RESIZE_ATOL = 3e-5`` on [0, 1] values (twice that
  after ``x * 2 - 1``): JAX builds its triangle weights from
  ``|sample - j| / scale`` over every input pixel, torch's antialiased
  ``interpolate`` from integer support bounds per output pixel, each
  normalised in float32; the two were 1.2e-5 apart at a 320 → 299 shrink
  and 3e-6 elsewhere, against a uint8 step of 3.9e-3.
- bfloat16 against float32: within 0.15 as the JAX package's own test.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.models import inception as ref_inc
from metrics_tpu_torch.models import inception as port_inc
from metrics_tpu_torch.models.inception import (
    InceptionFeatureExtractor,
    InceptionV3,
    load_torch_inception_weights,
    params_from_jax,
)
from metrics_tpu_torch.ops import prng
from metrics_tpu_torch.utils.device import full_float32
from tests.helpers.ulps import max_ulps

TAP_RTOL, OP_ATOL, RESIZE_ATOL = 1e-5, 1e-5, 3e-5
TAPS = ("64", "192", "768", "2048", "logits_unbiased", "logits")
IMGS = np.random.RandomState(8).randint(0, 256, (2, 3, 40, 48)).astype(np.uint8)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(_np(x).transpose(0, 2, 3, 1)))


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, ref_inc.inception_v3_init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_net(jax_params):
    net = InceptionV3()
    net.load_state_dict(params_from_jax(jax_params))
    return net


@pytest.fixture(scope="module")
def fidelity_taps(jax_params):
    fwd = jax.jit(lambda p, x: ref_inc.inception_v3_apply(p, x, TAPS, "fidelity"))
    return {k: np.asarray(v) for k, v in fwd(jax_params, jnp.asarray(IMGS)).items()}


def test_params_from_jax_fills_every_key(jax_params, port_net):
    sd = params_from_jax(jax_params)
    own = port_net.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in sd.items():
        assert v.shape == own[k].shape and v.dtype == torch.float32, k
    # HWIO -> OIHW, and the head transposed
    assert np.array_equal(sd["Mixed_6b.branch7x7_2.conv.weight"].numpy(),
                          jax_params["Mixed_6b"]["branch7x7_2"]["kernel"].transpose(3, 2, 0, 1))
    assert np.array_equal(sd["fc.weight"].numpy(), jax_params["fc"]["weight"].T)


@pytest.fixture(scope="module")
def port_taps(port_net):
    return port_net(torch.from_numpy(IMGS), TAPS, "fidelity")


DIMS = {"64": 64, "192": 192, "768": 768, "2048": 2048, "logits_unbiased": 1008, "logits": 1008}


@pytest.mark.parametrize("tap", TAPS)
def test_fidelity_taps_match_reference(port_taps, fidelity_taps, tap):
    got, want = _np(port_taps[tap]), fidelity_taps[tap]
    assert got.shape == want.shape == (2, DIMS[tap])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TAP_RTOL * np.abs(want).max(), rtol=0)


def test_float_input_floors_to_the_uint8_grid(port_net):
    """A float image in [0, 1] and its uint8 form give the same features on
    the fidelity path (``(imgs * 255).byte()`` semantics)."""
    x = torch.from_numpy(IMGS[:1])
    as_float = x.to(torch.float32) / 255.0
    a = port_inc._preprocess(as_float, "fidelity")
    b = port_inc._preprocess(x, "fidelity")
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# parameter-free ops against their JAX helpers
# ---------------------------------------------------------------------------

POOL_X = (np.random.RandomState(3).rand(2, 7, 9, 11).astype(np.float32) * 255)
POOLS = {
    "max_pool": (port_inc._max_pool, ref_inc._max_pool),
    "avg_pool_same": (port_inc._avg_pool_same, ref_inc._avg_pool_same),
    "avg_pool_same_nopad": (port_inc._avg_pool_same_nopad, ref_inc._avg_pool_same_nopad),
    "max_pool_same": (port_inc._max_pool_same, ref_inc._max_pool_same),
}


@pytest.mark.parametrize("pool", list(POOLS))
def test_pools_match_reference(pool):
    port_fn, ref_fn = POOLS[pool]
    got = _np(port_fn(torch.from_numpy(POOL_X)))
    want = _nchw(ref_fn(_nhwc(POOL_X)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=OP_ATOL, rtol=0)


RESIZE_SHAPES = {"grow": (32, 40), "shrink": (400, 350), "mixed": (150, 640)}


@pytest.mark.parametrize("case", list(RESIZE_SHAPES))
def test_tf1_resize_matches_reference(case):
    x = np.random.RandomState(4).randint(0, 256, (2, 3, *RESIZE_SHAPES[case])).astype(np.float32)
    got = _np(port_inc._resize_bilinear_tf1(torch.from_numpy(x), 299, 299))
    want = _nchw(ref_inc._resize_bilinear_tf1(_nhwc(x), 299, 299))
    np.testing.assert_allclose(got, want, atol=OP_ATOL, rtol=0)


@pytest.mark.parametrize("case", list(RESIZE_SHAPES))
def test_torchvision_resize_matches_jax_image_resize(case):
    """``jax.image.resize`` antialiases when it shrinks; plain
    ``F.interpolate`` would be 0.3-0.5 off on these inputs."""
    x = np.random.RandomState(5).rand(2, 3, *RESIZE_SHAPES[case]).astype(np.float32)
    got = _np(port_inc._resize_bilinear_antialias(torch.from_numpy(x), 299, 299))
    want = _nchw(jax.image.resize(_nhwc(x), (2, 299, 299, 3), method="bilinear"))
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def _ref_preprocess(x, variant):
    """The preprocessing of ``inception_v3_apply`` (``metrics_tpu/models/
    inception.py:341-362``), through its JAX helpers, as NCHW."""
    if variant == "fidelity":
        x = x.astype(jnp.float32) if x.dtype == jnp.uint8 else jnp.clip(
            jnp.floor(x.astype(jnp.float32) * 255.0), 0.0, 255.0)
        x = jnp.transpose(x, (0, 2, 3, 1))
        if x.shape[1:3] != (299, 299):
            x = ref_inc._resize_bilinear_tf1(x, 299, 299)
        return _nchw((x - 128.0) / 128.0)
    if x.dtype == jnp.uint8:
        x = x.astype(jnp.float32) / 255.0
    x = jnp.transpose(x, (0, 2, 3, 1))
    if x.shape[1:3] != (299, 299):
        x = jax.image.resize(x, (x.shape[0], 299, 299, x.shape[3]), method="bilinear")
    return _nchw(x * 2.0 - 1.0)


@pytest.mark.parametrize("shape", [(40, 48), (320, 310), (299, 299)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("variant", ["fidelity", "torchvision"])
def test_preprocessing_matches_reference(variant, dtype, shape):
    rng = np.random.RandomState(6)
    x = rng.randint(0, 256, (2, 3, *shape)).astype(np.uint8)
    if dtype == "float32":
        x = (x / 255.0 + rng.rand(*x.shape) * 0.003).astype(np.float32)
    got = _np(port_inc._preprocess(torch.from_numpy(x), variant))
    want = _ref_preprocess(jnp.asarray(x), variant)
    assert got.dtype == np.float32 and got.shape == (2, 3, 299, 299)
    np.testing.assert_allclose(got, want, atol=OP_ATOL if variant == "fidelity" else 2 * RESIZE_ATOL, rtol=0)


@pytest.mark.slow
def test_torchvision_variant_whole_net_matches_reference(jax_params, port_net):
    """A second 20 s compile of the JAX graph, so under ``-m slow``; every
    op that differs from the fidelity graph is held above on its own."""
    x = (np.random.RandomState(9).rand(2, 3, 320, 310)).astype(np.float32)
    want = ref_inc.inception_v3_apply(jax_params, jnp.asarray(x), TAPS, "torchvision")
    got = port_net(torch.from_numpy(x), TAPS, "torchvision")
    for tap in TAPS:
        w = np.asarray(want[tap])
        np.testing.assert_allclose(_np(got[tap]), w, atol=TAP_RTOL * np.abs(w).max(), rtol=0, err_msg=tap)


# ---------------------------------------------------------------------------
# checkpoints, the extractor, TF32
# ---------------------------------------------------------------------------

def _torchvision_state_dict(net, num_classes=1008, seed=1234):
    """A torchvision-layout state dict with distinct random values, plus the
    keys the port does not have (``AuxLogits.*``, ``num_batches_tracked``)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in net.state_dict().items():
        shape = (num_classes, 2048) if k == "fc.weight" else (num_classes,) if k == "fc.bias" else v.shape
        sd[k] = torch.rand(shape, generator=gen) + 0.5 if k.endswith("running_var") else \
            torch.randn(shape, generator=gen) * 0.1
        if k.endswith("bn.running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    return sd


@pytest.mark.parametrize("num_classes", [1008, 1000])
def test_torchvision_layout_state_dict_loads(port_net, num_classes):
    sd = _torchvision_state_dict(port_net, num_classes)
    net = load_torch_inception_weights(InceptionV3(), sd)
    own = net.state_dict()
    assert net.fc.weight.shape == (num_classes, 2048)
    for k, v in own.items():
        assert torch.equal(v, sd[k]), k
    # the same file through the JAX package's converter crosses back unchanged
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_inc.load_torch_inception_weights(sd)))
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def test_state_dict_missing_a_key_raises(port_net):
    sd = _torchvision_state_dict(port_net)
    del sd["Mixed_7c.branch_pool.bn.running_mean"]
    with pytest.raises(KeyError, match="lacks 1 keys"):
        load_torch_inception_weights(InceptionV3(), sd)


def test_extractor_checks_and_warnings(port_net):
    with pytest.raises(ValueError, match="unknown inception variant"):
        InceptionFeatureExtractor(variant="tf", device="cpu")
    with pytest.raises(ValueError, match="unknown inception feature tap"):
        InceptionFeatureExtractor(feature=100, device="cpu")
    with pytest.warns(UserWarning, match="RANDOM weights"):
        InceptionFeatureExtractor(device="cpu")
    with pytest.warns(UserWarning, match="1000-class"):
        InceptionFeatureExtractor(weights=_torchvision_state_dict(port_net, 1000), device="cpu")
    with pytest.warns(UserWarning, match="1008-class"):
        InceptionFeatureExtractor(weights=_torchvision_state_dict(port_net, 1008), variant="torchvision", device="cpu")


def test_default_weights_are_the_reference_draw(jax_params):
    """``inception_v3_init()`` is the JAX package's ``inception_v3_init(
    PRNGKey(0))``: the same split tree and shapes, each float32 normal
    within 4 ulps (XLA's ``ErfInv`` against ``ops/prng.py``'s, C.14)."""
    got, want = port_inc.inception_v3_init(device="cpu"), params_from_jax(jax_params)
    assert sorted(got) == sorted(want)
    worst = max(max_ulps(got[k], want[k]) for k in want)
    assert worst <= 4, worst
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ext = InceptionFeatureExtractor(device="cpu")
    assert all(torch.equal(v, got[k]) for k, v in ext.net.state_dict().items())


@pytest.mark.parametrize("seed", [0, 1])
def test_extractor_seeded_weights_are_reproducible(seed):
    """One key draws the same network twice, another key another one."""
    a, b = InceptionV3(key=prng.prng_key(seed)), InceptionV3(key=prng.prng_key(seed))
    c = InceptionV3(key=prng.prng_key(seed + 2))
    w = "Mixed_6e.branch7x7dbl_4.conv.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])


def test_bfloat16_extractor_tracks_float32():
    imgs = torch.from_numpy(np.random.RandomState(77).randint(0, 256, (2, 3, 64, 64)).astype(np.uint8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        f32 = InceptionFeatureExtractor(feature=64, device="cpu")
        bf16 = InceptionFeatureExtractor(feature=64, dtype=torch.bfloat16, device="cpu")
    assert bf16.dtype == torch.bfloat16
    a, b = f32(imgs), bf16(imgs)
    assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
    np.testing.assert_allclose(_np(b), _np(a), atol=0.15, rtol=0.15)


def test_full_float32_restores_the_callers_flags():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((True, True), (False, True), (True, False)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            with full_float32():
                assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
            assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
