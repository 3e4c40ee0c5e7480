"""Inception-v3 feature extractor as an ``nn.Module``.

Counterpart of ``metrics_tpu/models/inception.py``, written without
torchvision but in torchvision's module layout (``Conv2d_1a_3x3.conv.weight``,
``Conv2d_1a_3x3.bn.running_var``, ``Mixed_5b.branch1x1.conv.weight``, ...,
``fc.weight``), so torchvision and torch-fidelity checkpoints load straight
in (:func:`load_torch_inception_weights`) and the JAX package's params
pytree carries across (:func:`params_from_jax`). Feature taps follow
torch-fidelity's: ``"64"`` (first max pool), ``"192"`` (second max pool),
``"768"`` (before the aux head), ``"2048"`` (final average pool),
``"logits_unbiased"`` and ``"logits"``.

Two forwards share one set of weights; every difference between them is in
parameter-free pooling and preprocessing:

- ``variant="fidelity"`` (default): torch-fidelity's ``inception-v3-compat``
  graph, on which published FID/KID/IS numbers are defined. uint8 input on
  the [0, 255] scale (a float input is floored to that grid), resized to
  299 by TensorFlow 1.x's bilinear rule (``src = dst · in/out`` in float32,
  no half-pixel shift), ``(x - 128) / 128``; the pool branches of the A and
  C blocks and Mixed_7b average without the padding
  (``count_include_pad=False``) and Mixed_7c's is a 3x3/1 max pool.
- ``variant="torchvision"``: torchvision's ``inception_v3`` in eval mode:
  [0, 1] input, the half-pixel bilinear resize of ``jax.image.resize``
  (which antialiases when it shrinks), ``x * 2 - 1``, padded average pools.

Batch norm is eval-mode with eps 1e-3, folded into each convolution. A
float32 forward runs as true float32 whatever the caller's TF32 flags
(``utils/device.py::full_float32``); ``dtype=torch.bfloat16`` runs the
network in bfloat16 after float32 preprocessing, as the JAX package's
``dtype=``. Without weights the network is drawn as the JAX package draws
it (:func:`inception_v3_init`, ``PRNGKey(0)`` through ``ops/prng.py``), so a
default FID, KID or IS gives the JAX package's scores; every metric
mechanism is exact, but scores are not comparable with pretrained-Inception
numbers.
"""
import contextlib
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.ops import prng
from metrics_tpu_torch.utils.device import full_float32, resolve_device
from metrics_tpu_torch.utils.prints import rank_zero_warn

VARIANTS = ("fidelity", "torchvision")
TAPS = ("64", "192", "768", "2048", "logits_unbiased", "logits")
_BN_EPS = 1e-3


@contextlib.contextmanager
def _cudnn_benchmark() -> Iterator[None]:
    """Let cuDNN time its algorithms once per convolution shape (the
    network's shapes are fixed by its 299x299 input) and pick the fastest,
    instead of its heuristic's pick; restores the caller's flag."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


def _check_variant(variant: str) -> str:
    if variant not in VARIANTS:
        raise ValueError(f"unknown inception variant {variant!r}; use 'fidelity' or 'torchvision'")
    return variant


class _EvalBatchNorm(nn.Module):
    """The four tensors of an eval-mode batch norm, under torchvision's
    names; applied folded into the preceding convolution."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))


class BasicConv2d(nn.Module):
    """conv (no bias) → eval-mode batch norm (eps 1e-3) → relu, with the
    norm folded into the convolution's weight and bias."""

    def __init__(self, cin: int, cout: int, kernel_size: Union[int, Tuple[int, int]], stride: int = 1,
                 padding: Union[int, Tuple[int, int]] = 0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = _EvalBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        scale = bn.weight * torch.rsqrt(bn.running_var + _BN_EPS)
        shift = bn.bias - bn.running_mean * scale
        y = F.conv2d(x, self.conv.weight * scale.view(-1, 1, 1, 1), shift, self.conv.stride, self.conv.padding)
        return F.relu(y, inplace=True)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 VALID max pool."""
    return F.max_pool2d(x, 3, 2)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool over 9 taps, padding included."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _avg_pool_same_nopad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool over the valid taps only: the TF-compat
    pool torch-fidelity puts in the A, C and Mixed_7b blocks."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME max pool: the pool branch of torch-fidelity's
    Mixed_7c."""
    return F.max_pool2d(x, 3, 1, 1)


def _resize_bilinear_tf1(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TensorFlow 1.x ``resize_bilinear`` (align_corners=False, no
    half-pixel centres) of an NCHW batch: source coordinate ``src = dst ·
    (in / out)`` in float32, a gather and a lerp over H, then over W. The
    resize torch-fidelity uses, and not ``F.interpolate``'s rule."""
    _, _, h, w = x.shape

    def axis(in_size: int, out_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        # a Python scalar, rounded to float32 by the product (as JAX's weak
        # type), and no copy from the host
        src = torch.arange(out_size, dtype=torch.float32, device=x.device) * (in_size / out_size)
        lo = torch.clamp(torch.floor(src).to(torch.int64), 0, in_size - 1)
        hi = torch.clamp(lo + 1, max=in_size - 1)
        return lo, hi, src - lo.to(torch.float32)

    lo_h, hi_h, fh = axis(h, out_h)
    lo_w, hi_w, fw = axis(w, out_w)
    top, bot = x[:, :, lo_h], x[:, :, hi_h]
    x = top + (bot - top) * fh[:, None]
    left, right = x[..., lo_w], x[..., hi_w]
    return left + (right - left) * fw


def _resize_bilinear_antialias(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW batch: half-pixel
    bilinear, with a widened triangle kernel on an axis that shrinks."""
    _, _, h, w = x.shape
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                         antialias=h > out_h or w > out_w)


def _preprocess(x: torch.Tensor, variant: str) -> torch.Tensor:
    """Input ``[N, 3, H, W]`` (uint8 or float in [0, 1]) to the network's
    float32 input at 299x299."""
    if variant == "fidelity":
        if x.dtype == torch.uint8:
            x = x.to(torch.float32)
        else:  # the uint8 grid: float and uint8 forms of an image score alike
            x = torch.clamp(torch.floor(x.to(torch.float32) * 255.0), 0.0, 255.0)
        if x.shape[-2:] != (299, 299):
            x = _resize_bilinear_tf1(x, 299, 299)
        return (x - 128.0) / 128.0
    x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.to(torch.float32)
    if x.shape[-2:] != (299, 299):
        x = _resize_bilinear_antialias(x, 299, 299)
    return x * 2.0 - 1.0


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x: torch.Tensor, pool: Any = _avg_pool_same) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b1, b5, b3, self.branch_pool(pool(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor, pool: Any = _avg_pool_same) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([b1, b7, bd, self.branch_pool(pool(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor, pool: Any = _avg_pool_same) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([b1, b3, bd, self.branch_pool(pool(x))], dim=1)


def _layers(num_classes: int) -> Dict[str, nn.Module]:
    """The network's layers in torchvision's order, which is also the order
    of the JAX package's ``split``s: the stem, the mixed blocks (each
    block's convolutions in its own split order), the head."""
    return {
        "Conv2d_1a_3x3": BasicConv2d(3, 32, 3, stride=2),
        "Conv2d_2a_3x3": BasicConv2d(32, 32, 3),
        "Conv2d_2b_3x3": BasicConv2d(32, 64, 3, padding=1),
        "Conv2d_3b_1x1": BasicConv2d(64, 80, 1),
        "Conv2d_4a_3x3": BasicConv2d(80, 192, 3),
        "Mixed_5b": InceptionA(192, 32),
        "Mixed_5c": InceptionA(256, 64),
        "Mixed_5d": InceptionA(288, 64),
        "Mixed_6a": InceptionB(288),
        "Mixed_6b": InceptionC(768, 128),
        "Mixed_6c": InceptionC(768, 160),
        "Mixed_6d": InceptionC(768, 160),
        "Mixed_6e": InceptionC(768, 192),
        "Mixed_7a": InceptionD(768),
        "Mixed_7b": InceptionE(1280),
        "Mixed_7c": InceptionE(2048),
        "fc": nn.Linear(2048, num_classes),
    }


class InceptionV3(nn.Module):
    """Inception-v3 in torchvision's layout (no aux head), torch-fidelity's
    1008-logit head by default, with the weights of
    :func:`inception_v3_init` drawn from ``key`` (a
    :func:`~metrics_tpu_torch.ops.prng.prng_key`; ``PRNGKey(0)`` on the
    host when ``None``), on the key's device."""

    def __init__(self, num_classes: int = 1008, key: Optional[torch.Tensor] = None) -> None:
        super().__init__()
        key = prng.prng_key(0) if key is None else key
        with torch.device("meta"):  # the draw below is the only init
            for name, layer in _layers(num_classes).items():
                setattr(self, name, layer)
        self.load_state_dict(_draw(dict(self.named_children()), key), assign=True)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor, features: Sequence[str] = ("2048",),
                variant: str = "fidelity") -> Dict[str, torch.Tensor]:
        """The requested taps of ``x`` (``[N, 3, H, W]``, uint8 in [0, 255]
        or float in [0, 1]), each ``[N, D]`` in the network's dtype."""
        variant = _check_variant(variant)
        fidelity = variant == "fidelity"
        pool_a = _avg_pool_same_nopad if fidelity else _avg_pool_same
        pool_e2 = _max_pool_same if fidelity else _avg_pool_same
        wanted = set(features)
        out: Dict[str, torch.Tensor] = {}
        dtype = self.fc.weight.dtype
        with full_float32(), _cudnn_benchmark():
            x = _preprocess(x, variant).to(dtype)
            if x.is_cuda and dtype != torch.float32:
                # tensor-core convolutions want channels-last; cuDNN's float32
                # ones run on NCHW and would transpose it back
                x = x.contiguous(memory_format=torch.channels_last)
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = _max_pool(x)
            if "64" in wanted:
                out["64"] = x.mean(dim=(2, 3))
            x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
            if "192" in wanted:
                out["192"] = x.mean(dim=(2, 3))
            for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d):
                x = block(x, pool_a)
            x = self.Mixed_6a(x)
            for block in (self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
                x = block(x, pool_a)
            if "768" in wanted:
                out["768"] = x.mean(dim=(2, 3))
            x = self.Mixed_7b(self.Mixed_7a(x), pool_a)
            pooled = self.Mixed_7c(x, pool_e2).mean(dim=(2, 3))  # adaptive average pool: [N, 2048]
            if "2048" in wanted:
                out["2048"] = pooled
            if "logits_unbiased" in wanted:
                out["logits_unbiased"] = pooled @ self.fc.weight.T
            if "logits" in wanted:
                out["logits"] = pooled @ self.fc.weight.T + self.fc.bias
        return out


def _draw(layers: Mapping[str, nn.Module], key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The JAX package's ``inception_v3_init`` draw for ``layers`` (only
    their shapes are read), on the key's device: ``split(key, 20)``, one key
    a stem convolution or a block, a block's key split once per
    convolution; each kernel drawn ``(kh, kw, cin, cout)`` with std
    sqrt(2 / fan_in), batch norms at identity; the head ``(2048, C)`` times
    0.01 from the key after the last block."""
    device = key.device

    def conv(k: torch.Tensor, m: BasicConv2d) -> Dict[str, torch.Tensor]:
        cout, cin, kh, kw = m.conv.weight.shape
        kernel = prng.normal(k, (kh, kw, cin, cout)) * float(np.sqrt(2.0 / (cin * kh * kw)))
        ones, zeros = (lambda: torch.ones(cout, device=device)), (lambda: torch.zeros(cout, device=device))
        return {"kernel": kernel, "bn_scale": ones(), "bn_bias": zeros(), "bn_mean": zeros(), "bn_var": ones()}

    keys = prng.split(key, 20)
    body = [(name, layer) for name, layer in layers.items() if name != "fc"]
    params: Dict[str, Any] = {}
    for i, (name, layer) in enumerate(body):
        if isinstance(layer, BasicConv2d):
            params[name] = conv(keys[i], layer)
        else:
            branches = list(layer.named_children())
            sub = prng.split(keys[i], len(branches))
            params[name] = {branch: conv(sub[j], m) for j, (branch, m) in enumerate(branches)}
    num_classes = layers["fc"].weight.shape[0]
    params["fc"] = {"weight": prng.normal(keys[len(body)], (2048, num_classes)) * 0.01,
                    "bias": torch.zeros(num_classes, device=device)}
    return _state_dict_from_tree(params)


def inception_v3_init(
    key: Optional[torch.Tensor] = None,
    num_classes: int = 1008,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """The JAX package's ``inception_v3_init(key, num_classes)`` weights as
    an :class:`InceptionV3` state dict: ``split(key, 20)``, then each
    block's own split; each kernel drawn ``(kh, kw, cin, cout)`` with std
    sqrt(2 / fan_in) and transposed, the head ``(2048, C)`` times 0.01,
    batch norms at identity. ``key`` is a
    :func:`~metrics_tpu_torch.ops.prng.prng_key`; ``PRNGKey(0)`` when
    ``None``. Drawn on ``device`` (``None`` means CUDA). A float32 draw is
    within 4 ulps of JAX's (``ops/prng.py::normal``)."""
    device = resolve_device(device)
    key = prng.prng_key(0, device=device) if key is None else key.to(device)
    with torch.device("meta"):
        layers = _layers(num_classes)
    return _draw(layers, key)


def load_torch_inception_weights(model: InceptionV3, source: Any) -> InceptionV3:
    """Load a torchvision ``inception_v3`` or torch-fidelity ``pt_inception``
    state dict (or the path of one) into ``model``, in place. Keys the model
    does not have (``AuxLogits.*``, ``num_batches_tracked``) are ignored, a
    key it needs and the source lacks raises ``KeyError``. The head keeps
    the checkpoint's class count (1000 torchvision, 1008 torch-fidelity)."""
    if not isinstance(source, Mapping):
        source = torch.load(source, map_location="cpu")
    sd = {k: torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)) for k, v in source.items()}
    num_classes = sd["fc.weight"].shape[0]
    if num_classes != model.fc.weight.shape[0]:
        model.fc = nn.Linear(2048, num_classes).requires_grad_(False).to(model.fc.weight)
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"the inception state dict lacks {len(missing)} keys: {missing[:5]}")
    model.load_state_dict({k: sd[k] for k in own})
    return model


def _state_dict_from_tree(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An Inception params tree in the JAX package's layout (torch tensors)
    as this module's state dict: HWIO kernels to OIHW, the head's
    ``[2048, C]`` weight transposed."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix: str, p: Mapping[str, torch.Tensor]) -> None:
        sd[f"{prefix}.conv.weight"] = p["kernel"].permute(3, 2, 0, 1).contiguous()
        sd[f"{prefix}.bn.weight"] = p["bn_scale"]
        sd[f"{prefix}.bn.bias"] = p["bn_bias"]
        sd[f"{prefix}.bn.running_mean"] = p["bn_mean"]
        sd[f"{prefix}.bn.running_var"] = p["bn_var"]

    for name, sub in params.items():
        if name == "fc":
            sd["fc.weight"] = sub["weight"].T.contiguous()
            sd["fc.bias"] = sub["bias"]
        elif "kernel" in sub:
            conv(name, sub)
        else:
            for branch, p in sub.items():
                conv(f"{name}.{branch}", p)
    return sd


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Inception params pytree (``inception_v3_init``,
    ``load_torch_inception_weights``; arrays or numpy) as this module's
    state dict, float32 on the host: HWIO kernels to OIHW, the head's
    ``[2048, C]`` weight transposed."""

    def to_torch(tree: Any) -> Any:
        if isinstance(tree, Mapping):
            return {k: to_torch(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, dtype=np.float32))

    return _state_dict_from_tree(to_torch(params))


class InceptionFeatureExtractor(nn.Module):
    """Callable ``imgs -> [N, D]`` float32 features of one tap.

    Args:
        feature: the tap, 64 | 192 | 768 | 2048 | 'logits_unbiased' | 'logits'.
        weights: a torch-fidelity ``pt_inception`` state dict or path for the
            default variant, a torchvision ``inception_v3`` one for
            ``variant="torchvision"``; seeded random weights otherwise.
        variant: 'fidelity' (default) or 'torchvision'.
        dtype: the network's compute dtype, float32 or bfloat16.
        device: where the network lives; ``None`` means CUDA, as a metric.
    """

    def __init__(
        self,
        feature: Union[int, str] = 2048,
        weights: Optional[Any] = None,
        variant: str = "fidelity",
        dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        self.feature = str(feature)
        if self.feature not in TAPS:
            raise ValueError(f"unknown inception feature tap {feature!r}; use one of {TAPS}")
        # fail at construction, not at the first update of an eval pass
        self.variant = _check_variant(variant)
        device = resolve_device(device)
        self.net = InceptionV3(key=prng.prng_key(0, device=device))
        if weights is not None:
            load_torch_inception_weights(self.net, weights)
            num_classes = self.net.fc.weight.shape[0]
            # the two checkpoint families differ in head width; one family's
            # weights through the other's graph shifts every score
            if variant == "fidelity" and num_classes == 1000:
                rank_zero_warn(
                    "variant='fidelity' with a 1000-class (torchvision-style)"
                    " checkpoint: scores will NOT match torch-fidelity/reference"
                    " FID. Pass variant='torchvision' for torchvision weights,"
                    " or load torch-fidelity's pt_inception checkpoint."
                )
            elif variant == "torchvision" and num_classes == 1008:
                rank_zero_warn(
                    "variant='torchvision' with a 1008-class (torch-fidelity)"
                    " checkpoint: scores will NOT match either reference graph."
                    " Drop variant= (default 'fidelity') for torch-fidelity weights."
                )
        else:
            rank_zero_warn(
                "InceptionFeatureExtractor initialized with RANDOM weights: metric"
                " mechanics are exact but scores are not comparable with"
                " pretrained-Inception numbers. Pass `weights=` a torch-fidelity"
                " (or, with variant='torchvision', a torchvision) inception"
                " checkpoint for parity."
            )
        self.net.to(device=device, dtype=dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.net.fc.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.net.fc.weight.device

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.net(imgs, (self.feature,), self.variant)[self.feature].to(torch.float32)
