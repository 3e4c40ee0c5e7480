"""The port's LPIPS network (``metrics_tpu_torch/models/lpips_net.py``) and
``LPIPS`` metric against the JAX package's, on the CPU.

The JAX params (``lpips_init``) cross with ``params_from_jax``; the tower's
taps and the distance are then held against ``_tower_features`` and
``lpips_apply`` for AlexNet at 64x64 (BAPPS' patch size) and VGG16 at
32x32, and the metric against the JAX metric over two batches. A
torchvision-layout tower with ``lpips``-layout heads loads, as in the JAX
package's converter.

Tolerances: taps ``TAP_RTOL = 1e-5`` of the tap's largest value (5 and 13
float32 convolutions deep, sums of up to 4,608 products in another order);
distances ``DIST_ATOL = 1e-6``: each is a sum over 5 taps of spatial means
of unit-normalised squared differences weighted by heads of size ≤ 0.3,
values of size ~0.1-1 whose float32 roundoff in either package stays below
1e-7 (seen 6e-8).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as ref
from metrics_tpu.models import lpips_net as ref_lpips
from metrics_tpu_torch import LPIPS
from metrics_tpu_torch.models.lpips_net import LPIPSNetwork, load_torch_lpips_weights, lpips_init, params_from_jax
from metrics_tpu_torch.ops import prng
from tests.helpers.ulps import max_ulps

TAP_RTOL, DIST_ATOL = 1e-5, 1e-6
SIZES = {"alex": 64, "vgg": 32}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pairs(net, n=2, seed=0):
    rng = np.random.RandomState(seed)
    hw = SIZES[net]
    return tuple((rng.rand(n, 3, hw, hw) * 2 - 1).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module", params=["alex", "vgg"])
def nets(request):
    net = request.param
    params = jax.tree_util.tree_map(np.asarray, ref_lpips.lpips_init(net, jax.random.PRNGKey(3)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port_net = LPIPSNetwork(net, device="cpu")
    port_net.load_state_dict(params_from_jax(params, net))
    return net, params, port_net


def test_params_from_jax_fills_every_key(nets):
    net, params, port_net = nets
    assert sorted(params_from_jax(params, net)) == sorted(port_net.state_dict())


def test_tower_taps_match_reference(nets):
    net, params, port_net = nets
    x = _pairs(net)[0]
    want = ref_lpips._tower_features(params, jnp.asarray(x.transpose(0, 2, 3, 1)), net)
    got = port_net.net(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(_np(g), w, atol=TAP_RTOL * np.abs(w).max(), rtol=0, err_msg=f"tap {i}")


@pytest.mark.parametrize("normalize", [False, True])
def test_distance_matches_reference(nets, normalize):
    net, params, port_net = nets
    a, b = _pairs(net, seed=1)
    if normalize:
        a, b = (a + 1) / 2, (b + 1) / 2
    want = ref_lpips.lpips_apply(params, jnp.asarray(a), jnp.asarray(b), net, normalize)
    got = port_net(torch.from_numpy(a), torch.from_numpy(b), normalize=normalize)
    assert got.shape == (2,)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=DIST_ATOL, rtol=0)


def test_lpips_init_is_the_reference_draw(nets):
    """``lpips_init(net, key)`` is the JAX package's ``lpips_init(net, key)``
    (the fixture's ``PRNGKey(3)``): one split per convolution, then the
    heads' split, each float32 normal within 4 ulps (C.14); a default
    AlexNet network is ``lpips_init("alex")``."""
    net, params, _ = nets
    got, want = lpips_init(net, prng.prng_key(3), device="cpu"), params_from_jax(params, net)
    assert sorted(got) == sorted(want)
    worst = max(max_ulps(got[k], want[k]) for k in want)
    assert worst <= 4, worst
    if net == "alex":  # VGG16's draw is six times the size and takes the same path
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            default = LPIPSNetwork(net, device="cpu").state_dict()
        assert all(torch.equal(v, default[k]) for k, v in lpips_init(net, device="cpu").items())


def test_identical_images_are_at_distance_zero(nets):
    net, _, port_net = nets
    a = torch.from_numpy(_pairs(net)[0])
    assert float(port_net(a, a.clone()).abs().max()) == 0.0


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_metric_with_the_network_matches_reference(nets, reduction):
    net, params, port_net = nets
    ref_net = ref_lpips.LPIPSNetwork.__new__(ref_lpips.LPIPSNetwork)
    ref_net.params, ref_net.net_type = jax.tree_util.tree_map(jnp.asarray, params), net
    ref_net._fwd = jax.jit(lambda p, x, y, normalize: ref_lpips.lpips_apply(p, x, y, net, normalize),
                           static_argnames=("normalize",))
    m_ref = ref.LPIPS(net=ref_net, reduction=reduction)
    m = LPIPS(net=port_net, reduction=reduction, device="cpu")
    for seed in (2, 3):
        a, b = _pairs(net, seed=seed)
        np.testing.assert_allclose(_np(m(torch.from_numpy(a), torch.from_numpy(b))),
                                   np.asarray(m_ref(jnp.asarray(a), jnp.asarray(b))), atol=DIST_ATOL * 2, rtol=0)
    np.testing.assert_allclose(_np(m.compute()), np.asarray(m_ref.compute()), atol=DIST_ATOL * 4, rtol=0)


def _torchvision_tower(net, seed=5):
    """A torchvision-layout ``features.*`` state dict (plus ``classifier.*``
    keys the port ignores) and ``lpips``-layout heads."""
    gen = torch.Generator().manual_seed(seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        template = LPIPSNetwork(net, device="cpu")
    tower = {k[len("net."):]: torch.randn(v.shape, generator=gen) * 0.05
             for k, v in template.state_dict().items() if k.startswith("net.")}
    tower["classifier.1.weight"] = torch.zeros(10, 10)
    lins = {f"lin{k}.model.1.weight": torch.rand(1, d, 1, 1, generator=gen) * 0.1
            for k, d in enumerate(template.net.tap_dims)}
    return tower, lins


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_torchvision_tower_and_lpips_heads_load_as_in_the_reference(net):
    tower, lins = _torchvision_tower(net)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = LPIPSNetwork(net, weights=(tower, lins), device="cpu")
    ref_params = ref_lpips.load_torch_lpips_weights(net, tower, lins)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), net)
    for k, v in m.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_missing_tower_key_raises():
    tower, _ = _torchvision_tower("alex")
    del tower["features.3.bias"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = LPIPSNetwork("alex", device="cpu")
    with pytest.raises(KeyError, match="features.3.bias"):
        load_torch_lpips_weights(m, tower)


def test_unknown_net_raises():
    with pytest.raises(ValueError, match="net_type"):
        LPIPSNetwork("squeeze", device="cpu")
