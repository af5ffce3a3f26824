"""Threefry-2x32 counter-based random numbers in torch ops, bit for bit the
JAX package's (``jax.random`` with ``jax_threefry_partitionable=True``).

A key is two 32-bit words. The port keeps every 32-bit word in an int64
tensor masked to ``[0, 2**32)``: torch's ``uint32`` has no shifts or adds
on CUDA, and int64 holds every sum of two words and every left shift by
less than 32 bits exactly. A right shift of a non-negative int64 is
logical. Keys are ``(..., 2)`` int64 tensors; every function is vectorized
over the leading axes of its keys (the batch ``jax.vmap`` gives the JAX
package), and runs on the keys' device.

Layout under partitionable threefry (``jax/_src/prng.py``):
- ``split(key, n)[i]`` hashes the 64-bit counter i as the pair (i >> 32,
  i & M) and keeps both output words as the new key;
- ``bits(key, shape)`` hashes the flat index of each element the same way
  and returns the XOR of the two output words;
- ``fold_in(key, d)`` hashes the pair (0, d) and keeps both words.

``uniform`` builds floats in [1, 2) from the top 23 bits and shifts them to
[minval, maxval) with one rounding; ``gumbel`` is
``-log(-log(uniform(tiny, 1)))``, its "low" mode; ``categorical`` is the
Gumbel-max trick; ``bernoulli`` compares a uniform with p.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

Tensor = torch.Tensor
MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2); all int64 words in [0, 2**32), broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK
    y = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & MASK
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        y = (y + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, y


def PRNGKey(seed: int, *, device=None) -> Tensor:
    """(2,) int64 key of an integer seed, as ``jax.random.PRNGKey`` builds
    it with 64-bit types off: the low 32 bits of the seed after a zero high
    word. Seeds outside int64 raise, as they do there."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit a 64-bit integer")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _words(x: Union[int, Tensor], like: Tensor) -> Tensor:
    if isinstance(x, Tensor):
        return x.to(device=like.device, dtype=torch.int64) & MASK
    x = int(x)
    if not 0 <= x <= MASK:
        raise OverflowError(f"{x} out of bounds for uint32")
    return torch.full((), x, dtype=torch.int64, device=like.device)


def fold_in(keys: Tensor, data: Union[int, Tensor]) -> Tensor:
    """keys (..., 2) with ``data`` (an int, or a tensor broadcast against
    ``keys.shape[:-1]``, taken modulo 2**32) folded in: (..., 2)."""
    d = _words(data, keys)
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def _counters(shape: Sequence[int], device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def _hash_shape(keys: Tensor, shape: Sequence[int]):
    """Both hash words of every element's flat index, per key:
    (..., *shape) each."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape, keys.device)
    lead = keys.shape[:-1]
    pad = (1,) * len(shape)
    k1 = keys[..., 0].reshape(lead + pad)
    k2 = keys[..., 1].reshape(lead + pad)
    return threefry2x32(k1, k2, hi, lo)


def split(keys: Tensor, num: int = 2) -> Tensor:
    """keys (..., 2) -> (..., num, 2): ``num`` new keys per key."""
    b1, b2 = _hash_shape(keys, (num,))
    return torch.stack([b1, b2], dim=-1)


def bits(keys: Tensor, shape: Sequence[int]) -> Tensor:
    """(..., *shape) int64 random 32-bit words, per key."""
    b1, b2 = _hash_shape(keys, shape)
    return b1 ^ b2


def uniform(keys: Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """(..., *shape) float32 uniform in [minval, maxval), per key."""
    b = bits(keys, shape)
    one = (b >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    # floats * (hi - lo) + lo rounded once, as XLA's fused multiply-add
    # rounds it: the float64 product of two float32 values is exact
    span = (hi - lo).double()
    return torch.maximum(lo, (floats.double() * span + lo.double()).float())


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"):
# a degree-8 polynomial in w = -log1p(-x^2), centred at 2.5 below w = 5 and
# in sqrt(w) - 3 above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: Tensor) -> Tensor:
    """float32 inverse error function, XLA's polynomial in torch ops. Each
    Horner step ``c + p * w`` is rounded once, as XLA's fused multiply-add
    rounds it (the float64 product of two float32 values is exact);
    erf_inv(+-1) is +-inf."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    # the square root in float64, rounded once to float32 (correctly
    # rounded; torch's float32 sqrt on the CPU is not always, and varies
    # between processes)
    w = torch.where(lt, w - 2.5,
                    torch.sqrt(w.double()).float() - 3.0).double()
    lt5, ge5 = (torch.tensor(c, dtype=torch.float32, device=x.device)
                for c in (_ERFINV_LT5, _ERFINV_GE5))
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        c = torch.where(lt, lt5[i], ge5[i])
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal(keys: Tensor, shape: Sequence[int]) -> Tensor:
    """(..., *shape) float32 standard normal, per key: ``sqrt(2) *
    erf_inv(u)`` with u uniform in [nextafter(-1, 0), 1), as
    ``jax.random.normal`` draws it."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(keys, shape, lo, 1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32,
                        device=keys.device) * erf_inv(u)


def gumbel(keys: Tensor, shape: Sequence[int]) -> Tensor:
    """(..., *shape) float32 standard Gumbel noise, per key."""
    return -torch.log(-torch.log(uniform(keys, shape, TINY, 1.0)))


def categorical(keys: Tensor, logits: Tensor) -> Tensor:
    """One draw per key from ``softmax(logits)``: keys (..., 2), logits
    (..., V) float32 (-inf never drawn). Returns (...) int64."""
    g = gumbel(keys, logits.shape[-1:])
    return (g + logits).argmax(-1)


def bernoulli(keys: Tensor, p: float, shape: Sequence[int]) -> Tensor:
    """(..., *shape) bool, True with probability ``p`` (float32), per
    key."""
    u = uniform(keys, shape)
    return u < torch.tensor(p, dtype=torch.float32, device=keys.device)
