"""The threefry2x32 counter-based generator of ``jax.random``, in torch.

The port keys a sampled token as the reference does —
``fold_in(fold_in(prng_key(seed), sample_idx), position)`` — and draws it
with the same Gumbel-max ``categorical``, so a sampled stream can be held
to the reference's token for token.  What is reproduced:

* ``threefry2x32``: Threefry-2x32 with 20 rounds (5 × 4 with key
  injection), the rotation schedule and key-schedule constant of
  Salmon et al. (2011) as ``jax`` applies them;
* ``prng_key(seed)``: the raw key ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(key, d)``: ``threefry2x32(key, (0, d))``;
* ``random_bits(key, n)``: the *partitionable* layout (the default of
  ``jax_threefry_partitionable``): element i hashes the counter pair
  ``(i >> 32, i & 0xFFFFFFFF)`` and its 32 bits are the two output words
  XOR-ed;
* ``uniform``: the mantissa trick ``bitcast((bits >> 9) | 0x3F800000) −
  1``, then ``· (maxval − minval) + minval`` and ``max(minval, ·)``, in
  f32 and in that order;
* ``gumbel``: ``−log(−log(uniform(tiny, 1)))`` (``mode="low"``);
* ``normal``: ``√2 · erfinv(uniform(nextafter(−1, 0), 1))`` in f32, as
  ``jax.random.normal`` computes it, with XLA's ``erf_inv`` (M. Giles'
  single-precision polynomials, "Approximating the erfinv function",
  2010); XLA's own ``log1p`` and fused multiply-adds may move the last
  bits;
* ``categorical``: ``argmax(gumbel + logits)``, first index on a tie;
  it also returns the noise, which the sampler's margins need.

uint32 arithmetic runs in ``int64`` masked to 32 bits (shifts of at most
29 places never overflow), since ``torch.uint32`` has too few operations
on CUDA.  Keys are ``(..., 2)`` int64 tensors, one per row: every
function is batched over the leading axes, and row r's bits are those of
a call with row r's key alone.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words (x1, x2) under the key (k1, k2);
    every argument an int64 tensor (or int) of uint32 values, broadcast
    together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y0 = (x1 + ks[0]) & MASK
    y1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0 = (y0 + y1) & MASK
            y1 = _rotl(y1, r) ^ y0
        y0 = (y0 + ks[(i + 1) % 3]) & MASK
        y1 = (y1 + ks[(i + 2) % 3] + i + 1) & MASK
    return y0, y1


def prng_key(seed) -> torch.Tensor:
    """The raw key of ``jax.random.PRNGKey(seed)``: (..., 2) int64 for an
    int or an int64 tensor of seeds."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return torch.stack([(seed >> 32) & MASK, seed & MASK], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or an int64
    tensor broadcast against the leading axes."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data & MASK)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for each of n counters: (..., n) int64 in [0, 2^32)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], i >> 32, i & MASK)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval): (..., n)."""
    bits = random_bits(key, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's f32 erf_inv: a degree-8 polynomial in w - 2.5 where w = -log1p(-x²)
# < 5, else in sqrt(w) - 3 (highest power first)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` of x in (-1, 1)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=torch.float32, device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=torch.float32, device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return p * x


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """f32 standard normals: (..., n)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    sqrt2 = torch.tensor(np.sqrt(2), dtype=torch.float32, device=key.device)
    return sqrt2 * erfinv(uniform(key, n, lo, 1.0))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """f32 standard Gumbel noise, ``mode="low"``: (..., n)."""
    return -torch.log(-torch.log(uniform(key, n, F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor):
    """One draw per row of ``softmax(logits)`` by the Gumbel-max trick:
    key (..., 2), logits (..., V) f32 → (tokens (...) int64, the Gumbel
    noise (..., V) f32 the draw added)."""
    noise = gumbel(key, logits.shape[-1])
    return torch.argmax(noise + logits, dim=-1), noise
