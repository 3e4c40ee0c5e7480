"""``jax.random``'s key, split, permutation and normal draws, in torch.

KID draws its subsets and IS its shuffle with ``jax.random`` in the JAX
package (``metrics_tpu/image/kid.py:141-150``, ``image/inception.py:77``);
a ``torch.randperm`` would give another KID and IS for the same ``seed``.
This module reproduces JAX's default generator, ``threefry2x32`` with
``jax_threefry_partitionable=True`` (the default since JAX 0.5): a key is
two uint32 words, ``split`` hashes the 64-bit iota counters under the key,
32-bit random bits are the XOR of the two hashed words, and a permutation
is ``ceil(3·ln(n)/ln(2**32-1))`` rounds of a split and a stable sort by
fresh bits. uint32 words are held in int64 and masked to 32 bits, on the
device of the caller's choice. Keys, splits, bits and permutations are bit
for bit; a float32 ``normal`` is JAX's uniform-to-normal map through XLA's
own ``ErfInv`` polynomial, within 4 ulps of ``jax.random.normal``.

BootStrapper's draws (``metrics_tpu/wrappers/bootstrapping.py``) are
``jax.random.uniform``, ``randint`` and ``poisson``: the uniform is the
mantissa trick on 32 random bits and the randint two words of a split
reduced modulo the span, both bit for bit; the Poisson draw for a rate
below 10 is JAX's Knuth loop, whose count can differ only where a running
sum of ``torch.log`` lies within an ulp or two of ``-lam`` (XLA's ``log``
and torch's may round differently there). The loop runs while any draw is
still below the bound, so on the card each iteration reads the host once,
as JAX's ``while_loop`` does; :data:`HOST_READS` counts these reads.
"""
import math
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: Host reads of the draws that loop on the data: one per iteration of
#: :func:`poisson`'s Knuth loop (its ``any()``), wherever it ran.
HOST_READS = {"poisson": 0}


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key ``(k1, k2)``; every argument int64 in [0, 2**32),
    broadcasting. The rounds run in place on two words and one scratch
    buffer."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = torch.broadcast_tensors((x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK)
    a, b = a.contiguous(), b.contiguous()  # fresh storage each: written in place below
    tmp = torch.empty_like(b)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(_MASK)
            torch.bitwise_left_shift(b, r, out=tmp)  # b = rotl(b, r) ^ a
            b.bitwise_right_shift_(32 - r).bitwise_or_(tmp).bitwise_and_(_MASK).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        b.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return a, b


def prng_key(seed: int, device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words ``[0, seed
    mod 2**32]`` as an int64 ``[2]`` tensor."""
    if not -(2**31) <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1] = seed & _MASK  # a fill on the device, not a copy from the host
    return key


#: On the host a large ``normal`` draw runs in chunks of this many values,
#: and its ``log1p``/``sqrt`` in pieces of ``_VML_GRAIN``: torch runs an
#: elementwise op on up to 32,768 values, and a vectorized-math one (MKL
#: VML) on up to 2,048, on the calling thread; above that each op starts a
#: thread team. With several processes on one host (a test runner's
#: workers) each of the ~200 ops of a chunk then waited ~40 ms for its team,
#: and a 24M-value draw (an Inception network) took minutes; in pieces it
#: takes seconds whatever the neighbours do. The values are the same.
_HOST_CHUNK = 32768
_VML_GRAIN = 2048


def _hash_iota(key: torch.Tensor, n: int, start: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both hashed words of the counters ``start .. start+n-1`` under each
    key of ``key`` (``[..., 2]``): ``[..., n]`` each."""
    counts = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    return threefry2x32(k1, k2, torch.zeros_like(counts), counts)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., num, 2]`` new keys."""
    bits1, bits2 = _hash_iota(key, num)
    return torch.stack([bits1, bits2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` uniform 32-bit words per key (``jax.random.bits(key, (n,))``):
    ``[..., n]``."""
    bits1, bits2 = _hash_iota(key, n)
    return bits1 ^ bits2


def shuffle_rounds(n: int) -> int:
    """Rounds of ``jax.random.permutation`` for ``n`` items (3 is the
    exponent of JAX's collision analysis)."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as int64 ``[..., n]``; a batch of
    keys ``[..., 2]`` gives one permutation per key, as JAX's ``vmap``."""
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(*key.shape[:-1], n)
    for _ in range(shuffle_rounds(n)):
        keys = split(key)
        key, subkey = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(subkey, n), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


# XLA's float32 ErfInv (M. Giles, "Approximating the erfinv function"):
# degree-8 polynomials in w = -log1p(-x^2), one for w < 5 and one beyond
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _vml(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a vectorized-math op; on the host in pieces of
    ``_VML_GRAIN`` values (see ``_HOST_CHUNK``)."""
    if x.device.type != "cpu" or x.numel() <= _VML_GRAIN:
        return fn(x)
    return torch.cat([fn(piece) for piece in x.reshape(-1).split(_VML_GRAIN)]).reshape(x.shape)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` for ``|x| < 1``; ``torch.erfinv`` differs from
    it by up to ~65 ulps in the tails."""
    w = -_vml(torch.log1p, -x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, _vml(torch.sqrt, w) - 3.0)
    coeffs = torch.tensor([_ERFINV_SMALL, _ERFINV_LARGE], dtype=torch.float32, device=x.device)
    p = torch.where(small, coeffs[0, 0], coeffs[1, 0])
    for i in range(1, len(_ERFINV_SMALL)):
        p = torch.where(small, coeffs[0, i], coeffs[1, i]) + p * w
    return p * x


def normal(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 for one key ``[2]``:
    32-bit random bits, their top 23 as the mantissa of a float in [1, 2),
    minus 1, scaled to ``[nextafter(-1, 0), 1)``, then ``sqrt(2) * erfinv``
    (in chunks of ``_HOST_CHUNK`` values on the host)."""
    n = math.prod(shape)
    if key.device.type == "cpu" and n > _HOST_CHUNK:
        flat = torch.cat([_normal_flat(key, s, min(_HOST_CHUNK, n - s)) for s in range(0, n, _HOST_CHUNK)])
    else:
        flat = _normal_flat(key, 0, n)
    return flat.reshape(shape)


def _normal_flat(key: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Values ``start .. start+n-1`` of a flat float32 normal draw."""
    bits1, bits2 = _hash_iota(key, n, start)
    floats = (((bits1 ^ bits2) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    span = float(np.float32(1.0) - lo)  # 2 - 2**-24 rounds to 2.0 in float32, as in JAX
    u = torch.clamp_min(floats * span + float(lo), float(lo))
    return float(np.float32(np.sqrt(2.0))) * _erfinv_f32(u)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` (float32 in [0, 1)) per key of
    ``key`` (``[..., 2]``): ``[..., n]``. The top 23 of 32 random bits are
    the mantissa of a float in [1, 2), minus 1: exact, so bit for bit."""
    bits = random_bits(key, n)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, n: int, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` (int32 semantics, as
    int64) per key of ``key`` (``[..., 2]``): ``[..., n]``, bit for bit.

    Two 32-bit words per value from the two keys of a split, reduced as
    ``(hi % span) * m + lo % span``, modulo ``span``. ``m`` is
    ``(2**16 % span)**2 % span`` with the square wrapping at 2**32 as JAX's
    uint32 product does, so it is 0 for spans above 2**16."""
    if not -(2**31) <= minval < 2**31 or not -(2**31) <= maxval < 2**31:
        raise ValueError(f"randint bounds [{minval}, {maxval}) must fit int32")
    keys = split(key)
    higher, lower = random_bits(keys[..., 0, :], n), random_bits(keys[..., 1, :], n)
    span = 1 if maxval <= minval else maxval - minval
    multiplier = ((2**16 % span) ** 2 & _MASK) % span
    # no uint32 wrap to emulate: with a multiplier other than 0 both factors
    # are below 2**16, so the product and the sum stay below 2**32
    offset = (higher % span) * multiplier + lower % span
    return minval + offset % span


def poisson(key: torch.Tensor, lam: float, n: int) -> torch.Tensor:
    """``jax.random.poisson(key, lam, (n,))`` for ``0 <= lam < 10`` per key of
    ``key`` (``[..., 2]``): int64 ``[..., n]``.

    JAX's Knuth loop (``jax._src.random._poisson_knuth``): while any running
    log-product exceeds ``-lam``, split the key, count the draws still above
    it, and add ``log`` of a fresh uniform; the count minus one is the draw.
    A batch of keys runs one loop for all of them: a key whose draws are all
    done keeps its counts through the extra iterations, so each key's draw
    is the one it would get alone. Every iteration's ``any()`` is one host
    read (:data:`HOST_READS`). Rates of 10 and above take JAX's rejection
    sampler, which is not ported: they raise ``ValueError``.
    """
    lam32 = float(np.float32(lam))
    if not 0.0 <= lam32 < 10.0:
        raise ValueError(f"poisson is ported for 0 <= lam < 10 (Knuth's loop), got lam={lam}")
    shape = (*key.shape[:-1], n)
    k = torch.zeros(shape, dtype=torch.int64, device=key.device)
    if lam32 == 0.0:
        return k
    log_prod = torch.zeros(shape, dtype=torch.float32, device=key.device)
    rng = key
    while True:
        alive = log_prod > -lam32
        HOST_READS["poisson"] += 1
        if not bool(alive.any()):
            return k - 1
        keys = split(rng)
        rng, subkey = keys[..., 0, :], keys[..., 1, :]
        k = k + alive
        log_prod = log_prod + torch.log(uniform(subkey, n))
