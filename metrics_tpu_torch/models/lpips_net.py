"""LPIPS perceptual-similarity network as an ``nn.Module``.

Counterpart of ``metrics_tpu/models/lpips_net.py``: an AlexNet or VGG16
feature tower in torchvision's ``features.{i}`` layout, each tapped relu
output unit-normalised over channels, squared differences weighted by the
learned 1x1 heads (``lin{k}.model.1.weight``, the ``lpips`` package's
keys), averaged over space and summed over taps. Tower weights load from a
torchvision ``alexnet``/``vgg16`` state dict and heads from an ``lpips``
checkpoint (:func:`load_torch_lpips_weights`); the JAX package's params
carry across with :func:`params_from_jax`. Without weights the network is
drawn as the JAX package draws it (:func:`lpips_init`, ``PRNGKey(0)``), so
a default network gives the JAX package's distances; scores then are not
comparable with published LPIPS numbers. The forward runs as true float32
(``utils/device.py::full_float32``).
"""
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.ops import prng
from metrics_tpu_torch.utils.device import full_float32, resolve_device
from metrics_tpu_torch.utils.prints import rank_zero_warn

# (out_channels, kernel, stride, padding) per conv; "M3" = 3x3/2 max pool
# (AlexNet), "M" = 2x2/2 max pool (VGG)
_ALEX_CFG: Sequence = [
    (64, 11, 4, 2), "M3", (192, 5, 1, 2), "M3", (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1),
]
_ALEX_TAPS = (0, 1, 2, 3, 4)  # conv indices whose relu output is a tap
_VGG_CFG: Sequence = [
    (64, 3, 1, 1), (64, 3, 1, 1), "M",
    (128, 3, 1, 1), (128, 3, 1, 1), "M",
    (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "M",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1),
]
_VGG_TAPS = (1, 3, 6, 9, 12)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

# the lpips input normalization, applied to [-1, 1] inputs
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)


def _tower_cfg(net: str) -> Tuple[Sequence, Sequence[int]]:
    if net == "alex":
        return _ALEX_CFG, _ALEX_TAPS
    if net == "vgg":
        return _VGG_CFG, _VGG_TAPS
    raise ValueError(f"Unknown LPIPS net {net!r}; expected 'alex' or 'vgg'.")


class LPIPSTower(nn.Module):
    """The conv tower, ``features`` numbered as torchvision's (a conv and
    its relu take two indices, a pool one); :meth:`forward` returns the
    tapped relu outputs."""

    def __init__(self, net: str = "alex") -> None:
        super().__init__()
        cfg, taps = _tower_cfg(net)
        layers: List[nn.Module] = []
        self.tap_layers: List[int] = []  # Sequential index of each tapped relu
        self.tap_dims: List[int] = []
        cin, conv_idx = 3, 0  # tap indices count convs only
        for item in cfg:
            if isinstance(item, str):
                layers.append(nn.MaxPool2d(3 if item == "M3" else 2, 2))
                continue
            cout, k, stride, pad = item
            layers += [nn.Conv2d(cin, cout, k, stride, pad), nn.ReLU(inplace=True)]
            if conv_idx in taps:
                self.tap_layers.append(len(layers) - 1)
                self.tap_dims.append(cout)
            cin, conv_idx = cout, conv_idx + 1
        self.features = nn.Sequential(*layers)

    def conv_indices(self) -> List[int]:
        return [i for i, m in enumerate(self.features) if isinstance(m, nn.Conv2d)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.tap_layers:
                feats.append(x)
            if i == self.tap_layers[-1]:
                break
        return feats


class _LinHead(nn.Module):
    """A 1x1 head, ``model.1.weight`` ``[1, D, 1, 1]`` as in the ``lpips``
    package (its ``model.0`` is an eval-mode dropout)."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(dim, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class LPIPSNetwork(nn.Module):
    """Callable ``(img0, img1) -> [N]`` LPIPS distances of image pairs.

    Args:
        net: 'alex' | 'vgg'.
        weights: ``(tower_state_dict, lin_state_dict)`` (either may be a
            path; the heads may be ``None``); the random weights of
            :func:`lpips_init` (``PRNGKey(0)``) otherwise.
        device: where the network lives; ``None`` means CUDA.
    """

    def __init__(self, net: str = "alex", weights: Optional[Tuple[Any, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__()
        if net not in ("alex", "vgg"):
            raise ValueError(f"Argument `net_type` must be one of ('alex', 'vgg'), got {net}")
        self.net_type = net
        device = resolve_device(device)
        with torch.device("meta"):  # the draw below is the only init
            self.net = LPIPSTower(net)
            for k, d in enumerate(self.net.tap_dims):
                setattr(self, f"lin{k}", _LinHead(d))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)
        self.load_state_dict(lpips_init(net, device=device), assign=True)
        if weights is not None:
            load_torch_lpips_weights(self, *weights)
        else:
            rank_zero_warn(
                "LPIPSNetwork initialized with RANDOM weights: metric mechanics are"
                " exact but scores are not comparable with the lpips package."
                " Pass `weights=(tower_state_dict, lin_state_dict)` for parity."
            )
        self.requires_grad_(False)
        self.eval()
        self.to(device)

    @property
    def lins(self) -> List[_LinHead]:
        return [getattr(self, f"lin{k}") for k in range(len(self.net.tap_dims))]

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        """Distances of ``[N, 3, H, W]`` pairs in [-1, 1] (in [0, 1] with
        ``normalize=True``); both images of a pair go through one tower
        pass."""
        if normalize:
            img0, img1 = 2 * img0 - 1, 2 * img1 - 1
        n = img0.shape[0]
        with torch.no_grad(), full_float32():
            feats = self.net((torch.cat([img0, img1]) - self.shift) / self.scale)
            total = torch.zeros(n, dtype=feats[0].dtype, device=feats[0].device)
            for f, lin in zip(feats, self.lins):
                a, b = f[:n], f[n:]
                a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
                b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
                total = total + lin((a - b) ** 2).mean(dim=(1, 2, 3))  # 1x1 head, then the spatial mean
        return total


def _state(source: Any) -> Dict[str, torch.Tensor]:
    if not isinstance(source, Mapping):
        source = torch.load(source, map_location="cpu")
    return {k: torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)) for k, v in source.items()}


def load_torch_lpips_weights(model: LPIPSNetwork, tower_state_dict: Any,
                             lin_state_dict: Optional[Any] = None) -> LPIPSNetwork:
    """Load torchvision ``alexnet``/``vgg16`` tower weights (``features.{i}``;
    other keys such as ``classifier.*`` are ignored) and, optionally, the
    ``lpips`` package's heads (``lin{k}.model.1.weight``) into ``model``, in
    place. A key the model needs and the source lacks raises ``KeyError``."""
    sd = _state(tower_state_dict)
    wanted = {f"net.features.{i}.{p}": f"features.{i}.{p}"
              for i in model.net.conv_indices() for p in ("weight", "bias")}
    missing = sorted(v for v in wanted.values() if v not in sd)
    if missing:
        raise KeyError(f"the {model.net_type} tower state dict lacks {missing[:5]}")
    new = {k: sd[v] for k, v in wanted.items()}
    if lin_state_dict is not None:
        lsd = _state(lin_state_dict)
        for k, lin in enumerate(model.lins):
            new[f"lin{k}.model.1.weight"] = lsd[f"lin{k}.model.1.weight"].reshape(lin.model[1].weight.shape)
    model.load_state_dict(new, strict=False)
    return model


def _state_dict_from_tree(params: Mapping[str, Any], net: str) -> Dict[str, torch.Tensor]:
    """LPIPS params in the JAX package's layout (torch tensors) as an
    :class:`LPIPSNetwork` state dict: HWIO kernels to OIHW, heads to
    ``[1, D, 1, 1]``."""
    sd: Dict[str, torch.Tensor] = {}
    with torch.device("meta"):  # the layout only
        indices = LPIPSTower(net).conv_indices()
    for i, p in zip(indices, params["convs"]):
        sd[f"net.features.{i}.weight"] = p["kernel"].permute(3, 2, 0, 1).contiguous()
        sd[f"net.features.{i}.bias"] = p["bias"]
    for k, lin in enumerate(params["lins"]):
        sd[f"lin{k}.model.1.weight"] = lin.reshape(1, -1, 1, 1)
    return sd


def lpips_init(net: str = "alex", key: Optional[torch.Tensor] = None,
               device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's ``lpips_init(net, key)`` weights as an
    :class:`LPIPSNetwork` state dict: one ``split`` per convolution, its
    kernel drawn ``(k, k, cin, cout)`` with std sqrt(2 / fan_in) and
    transposed, zero biases; then one ``split`` whose second key splits
    into the heads, each ``|normal| * 0.1``. ``key`` is a
    :func:`~metrics_tpu_torch.ops.prng.prng_key`; ``PRNGKey(0)`` when
    ``None``. Drawn on ``device`` (``None`` means CUDA). A float32 draw is
    within 4 ulps of JAX's (``ops/prng.py::normal``)."""
    cfg, taps = _tower_cfg(net)
    device = resolve_device(device)
    key = prng.prng_key(0, device=device) if key is None else key.to(device)
    convs: List[Dict[str, torch.Tensor]] = []
    tap_dims: List[int] = []
    cin = 3
    for item in cfg:
        if isinstance(item, str):
            continue
        cout, size = item[0], item[1]
        key, sub = prng.split(key)
        convs.append({"kernel": prng.normal(sub, (size, size, cin, cout)) * float(np.sqrt(2.0 / (cin * size * size))),
                      "bias": torch.zeros(cout, device=device)})
        if len(convs) - 1 in taps:
            tap_dims.append(cout)
        cin = cout
    _, sub = prng.split(key)
    lins = [torch.abs(prng.normal(k, (d,))) * 0.1 for k, d in zip(prng.split(sub, len(tap_dims)), tap_dims)]
    return _state_dict_from_tree({"convs": convs, "lins": lins}, net)


def params_from_jax(params: Mapping[str, Any], net: str = "alex") -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS params (``lpips_init``: ``{"convs": [{kernel,
    bias}], "lins": [[D]]}``, arrays or numpy) as an :class:`LPIPSNetwork`
    state dict, float32 on the host: HWIO kernels to OIHW, heads to
    ``[1, D, 1, 1]``."""

    def t(a: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    convs = [{"kernel": t(p["kernel"]), "bias": t(p["bias"])} for p in params["convs"]]
    return _state_dict_from_tree({"convs": convs, "lins": [t(lin) for lin in params["lins"]]}, net)
