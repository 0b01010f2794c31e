"""Threefry-2x32 keys and normals in torch ops, bit-compatible with the
reference package's ``jax.random`` stream under
``jax_threefry_partitionable=True``.

A key is a ``[..., 2]`` int64 tensor holding two uint32 words (torch's uint32
support is partial, so every word lives in an int64 and is masked back to 32
bits after each add and shift). The functions mirror ``jax.random``:

- :func:`PRNGKey` — ``[0, seed mod 2**32]`` (the 32-bit seed path);
- :func:`split` — the partitionable ("fold-like") split: key ``i`` of ``n``
  is the threefry hash of the 64-bit counter ``i`` (hi word, lo word);
- :func:`random_bits` — 32-bit words ``hash(counter)[0] ^ hash(counter)[1]``;
- :func:`fold_in` — the threefry hash of the counter ``(0, data)``;
- :func:`uniform` — float32 on ``[lo, hi)`` from the top 23 bits, ``lo``
  and ``hi`` scalars or tensors that broadcast against the draw;
- :func:`randint` — int32 on ``[lo, hi)`` from two 32-bit draws and the
  span arithmetic of ``jax.random.randint``;
- :func:`normal` — ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  ``[nextafter(-1, 0), 1)`` from the top 23 bits, as ``_normal_real`` does;
- :func:`permutation` — ``jax.random.permutation(key, n)``: rounds of a
  stable sort of ``arange(n)`` by fresh 32-bit words.

``erf_inv`` is the single-precision Giles polynomial that XLA lowers
``lax.erf_inv`` to, and :func:`log` is the Cephes polynomial that XLA's CPU
emitter lowers float32 ``log`` to. XLA on the CPU contracts their Horner
steps into fused multiply-adds, so :func:`fma` reproduces one correctly
rounded ``a * b + c`` in float64 (exact product, one rounding of the sum,
one rounding to float32). Written in explicit elementary ops, both give
the same bits on the CPU and on the card, where ``torch.log`` would give
each device's own. These are plain tensor ops on whatever device the key
lies on; the engine draws the whole window's noise with them ahead of the
kernel, as the reference draws its key chain outside the Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

__all__ = [
    "PRNGKey",
    "split",
    "fold_in",
    "random_bits",
    "uniform",
    "randint",
    "normal",
    "permutation",
    "erf_inv",
    "log",
    "fma",
    "threefry2x32",
]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
# nextafter(-1, 0) in float32: the open lower end of the normal's uniform
_UNIFORM_LO = -(1.0 - 2.0 ** -24)

# XLA's single-precision erf_inv coefficients (w < 5, w >= 5)
_ERFINV_SMALL = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_LARGE = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
# XLA's log1p near zero (Cephes): numerator and denominator, highest first
_LOG1P_NUM = (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1,
)
_LOG1P_DEN = (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1,
)
_LOG1P_SMALL = 0.41421356237309504880
# XLA's float32 log (Cephes, Eigen's plog): the polynomial p0..p8 and the
# split ln(2) = q2 - q1
_LOG_P = (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRT_HALF = 0.707106781186547524


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; all broadcast, all int64 in uint32 range."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[2]`` int64."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit row-major iota over ``shape`` as (hi, lo) uint32 words."""
    n = math.prod(shape)
    flat = torch.arange(n, dtype=torch.int64, device=device)
    return (flat >> 32).reshape(shape), (flat & _MASK).reshape(shape)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): ``[..., 2]`` keys -> ``[..., n, 2]``."""
    hi, lo = _counters((n,), key.device)
    k1 = key[..., 0:1]
    k2 = key[..., 1:2]
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``: ``[..., 2]`` keys and a 32-bit ``data`` (an
    int, or a tensor that broadcasts against the keys' leading dims) ->
    ``[..., 2]`` keys, the hash of the counter ``(0, data)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words of ``shape`` per key: ``[..., 2]`` -> ``[..., *shape]``
    int64 (``jax.random.bits`` under the partitionable threefry)."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape, key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add does:
    the float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


Bound = Union[float, torch.Tensor]


def uniform(
    key: torch.Tensor, shape: Sequence[int], lo: Bound = 0.0, hi: Bound = 1.0
) -> torch.Tensor:
    """float32 uniform on ``[lo, hi)`` per key, from the top 23 bits
    (``jax.random.uniform(key, shape, minval=lo, maxval=hi)``). ``lo`` and
    ``hi`` are scalars or float32 tensors that broadcast against the
    ``[..., *shape]`` draw."""
    bits = random_bits(key, shape)
    one = torch.tensor(1.0, dtype=torch.float32).view(torch.int32).item()
    f = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.as_tensor(lo, dtype=torch.float32, device=key.device)
    scale = torch.as_tensor(hi, dtype=torch.float32, device=key.device) - lo_t
    return torch.maximum(lo_t, fma(f, scale, lo_t))


def randint(key: torch.Tensor, shape: Sequence[int], lo: int, hi: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi)`` (int32) per key: ``[...,
    2]`` keys -> ``[..., *shape]`` int64 values in ``[lo, hi)``. Two word
    draws from ``split(key)`` (high then low) are reduced modulo the span
    as ``(high % span) * (2**32 % span) + low % span``, in uint32
    arithmetic that wraps; an empty range gives ``lo``."""
    lo, hi = int(lo), int(hi)
    pair = split(key, 2)
    higher = random_bits(pair[..., 0, :], shape)
    lower = random_bits(pair[..., 1, :], shape)
    span = (hi - lo) & _MASK if hi > lo else 1
    multiplier = (2**16 % span) ** 2 & _MASK
    multiplier %= span
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    return lo + (offset & _MASK) % span


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` per key: ``[..., 2]`` keys ->
    ``[..., n]`` int64. ``arange(n)`` is sorted ``ceil(3 ln(n) /
    ln(2**32 - 1))`` times, each round by the 32-bit words of a fresh
    subkey, with a stable sort (ties keep their order, as
    ``lax.sort_key_val`` keeps them)."""
    lead = key.shape[:-1]
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(*lead, n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2.0**32 - 1)))
    for _ in range(rounds):
        pair = split(key, 2)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def _polevl(x: torch.Tensor, coefs: Sequence[float]) -> torch.Tensor:
    p = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        p = fma(p, x, torch.full_like(x, c))
    return p


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU emitter computes it, bit for bit:
    ``x = m * 2**e`` with ``m`` shifted into ``[sqrt(1/2), sqrt(2))``, the
    Cephes degree-8 polynomial in ``m - 1`` evaluated in three fused chains,
    then ``e * ln(2)`` added back in two parts. ``log(0) = -inf``,
    ``log(inf) = inf``, negative or NaN inputs give NaN."""
    x = x.to(torch.float32)
    m, e = torch.frexp(torch.clamp(x, min=torch.finfo(torch.float32).tiny))
    e = e.to(torch.float32)
    low = m < _SQRT_HALF
    e = e - low.to(torch.float32)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    c = lambda v: torch.full_like(m, v)
    p = _LOG_P
    y = fma(c(p[0]), m, c(p[1]))
    y1 = fma(c(p[3]), m, c(p[4]))
    y2 = fma(c(p[6]), m, c(p[7]))
    y = fma(y, m, c(p[2]))
    y1 = fma(y1, m, c(p[5]))
    y2 = fma(y2, m, c(p[8]))
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    m = fma(x2, c(-0.5), m) + y
    out = fma(e, c(_LOG_Q2), m)
    out = torch.where(x == math.inf, x, out)
    out = torch.where(x == 0.0, torch.full_like(x, -math.inf), out)
    return torch.where((x < 0.0) | torch.isnan(x), torch.full_like(x, math.nan), out)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log(1 + x)`` as XLA's CPU emitter computes it: the Cephes
    rational approximation (fused Horner steps) for ``|x| < sqrt(2) - 1``,
    :func:`log` of ``1 + x`` beyond."""
    x2 = x * x
    small = (x * x2) * (_polevl(x, _LOG1P_NUM) / _polevl(x, _LOG1P_DEN))
    small = x + fma(torch.full_like(x, -0.5), x2, small)
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's Giles polynomial."""
    w = -_log1p(-(x * x))
    small = w < 5.0
    # sqrt in float64, rounded once: the correctly rounded float32 sqrt that
    # XLA and the card compute (torch's CPU float32 sqrt is not always)
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    coef = lambda i: torch.where(
        small,
        torch.tensor(_ERFINV_SMALL[i], dtype=torch.float32, device=x.device),
        torch.tensor(_ERFINV_LARGE[i], dtype=torch.float32, device=x.device),
    )
    p = coef(0)
    for i in range(1, len(_ERFINV_SMALL)):
        p = fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 standard normals of ``shape`` per key: ``[..., 2]`` ->
    ``[..., *shape]`` (``jax.random.normal``)."""
    u = uniform(key, shape, _UNIFORM_LO, 1.0)
    return _SQRT2 * erf_inv(u)
