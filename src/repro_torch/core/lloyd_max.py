"""Batched Lloyd-Max scalar quantizer design (paper §A.1) and k-means++
seeding, in PyTorch (counterpart of ``repro/core/lloyd_max.py``).

``lloyd_max_batched`` fits N_c independent 2^B-level scalar quantizers,
one per block cluster, in one vectorized loop.  Empty bins keep their
previous level, which both steadies the iteration and is the paper's
warm start (levels start from the previous LO-BCQ iteration's books).

The per-(cluster, bin) sums are a product of one-hot matrices, not a
scatter-add: ``index_add_`` and ``scatter_add_`` add with atomics on CUDA
in no fixed order, and the fitted codebooks decide every later bit, so a
fit must give the same bytes run after run.  The product (N_c, N) @
(N, K) of the cluster one-hot (scaled by the values) and the bin one-hot
is reproducible on one card (cuBLAS without atomics) and on the CPU.
Its f32 sums add in another order than XLA's ``segment_sum``, so the
levels may differ from the reference's in the last bits, and, over many
iterations, by a scalar that such a bit moves across a threshold.

Random choices go through ``serving.prng`` (threefry2x32, bit-equal to
``jax.random``): ``kmeanspp_seeds`` takes the reference's key and draws
the same first seed (``randint``) and the same D² draws (``categorical``:
the Gumbel noise within 4 ulps, so a near-tie between two candidates is
the one place the seeds can part).
"""
from __future__ import annotations

import math

import torch

from repro_torch.serving import prng

ONE_HOT_CHUNK = 1 << 16  # scalars a one-hot block covers: bounds its memory


def quantile_init(x: torch.Tensor, k: int) -> torch.Tensor:
    """k levels at uniform quantiles of x (linear interpolation, as
    ``jnp.quantile``'s default)."""
    qs = (torch.arange(k, dtype=torch.float32, device=x.device) + 0.5) / k
    return torch.quantile(x.float().reshape(-1), qs)


def cluster_bin_sums(x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor,
                     bin_id: torch.Tensor, nc: int, k: int):
    """Σ x·w and Σ w over each (cluster, bin) → two (N_c, K): one product
    (N_c, N) @ (N, K) of the cluster one-hot (scaled by x·w, and by w)
    with the bin one-hot, a chunk of scalars at a time, the chunks added
    in order (reproducible on the card, see the module doc)."""
    cids = torch.arange(nc, device=x.device)
    bids = torch.arange(k, device=x.device)
    s = torch.zeros((nc, k), dtype=torch.float32, device=x.device)
    n = torch.zeros((nc, k), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], ONE_HOT_CHUNK):
        sl = slice(i, i + ONE_HOT_CHUNK)
        in_c = (assign[sl, None] == cids).float()  # (n, N_c)
        in_b = (bin_id[sl, None] == bids).float()  # (n, K)
        s = s + (in_c * (x[sl] * w[sl])[:, None]).T @ in_b
        n = n + (in_c * w[sl, None]).T @ in_b
    return s, n


def lloyd_max_batched(x: torch.Tensor, assign: torch.Tensor, levels: torch.Tensor,
                      weights: torch.Tensor | None = None, iters: int = 25) -> torch.Tensor:
    """``iters`` Lloyd-Max updates of every cluster at once.

    x (N,) scalars (normalized into codebook range); assign (N,) cluster
    id in [0, N_c); levels (N_c, K) the start (warm start); weights (N,)
    optional sample weights.  Returns (N_c, K) levels, sorted per cluster."""
    x = x.float()
    nc, k = levels.shape
    w = torch.ones_like(x) if weights is None else weights.float()
    assign = assign.long()
    lv = levels.float()
    for _ in range(iters):
        lv = torch.sort(lv, dim=-1).values
        thr = 0.5 * (lv[:, 1:] + lv[:, :-1])  # (N_c, K-1)
        bin_id = (x[:, None] >= thr[assign]).sum(-1)  # (N,) in [0, K)
        s, n = cluster_bin_sums(x, w, assign, bin_id, nc, k)
        mean = s / torch.clamp_min(n, 1e-12)
        lv = torch.where(n > 0, mean, lv)
    return torch.sort(lv, dim=-1).values


def lloyd_max_1d(x: torch.Tensor, levels: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """Single-cluster Lloyd-Max (the per-tensor baseline, Table 11)."""
    a = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    return lloyd_max_batched(x, a, levels[None, :], iters=iters)[0]


def quantize_to_levels(x: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Snap each scalar of x to the nearest of ``levels`` (1-D, sorted or
    not); an exact midpoint goes to the upper level."""
    lv = torch.sort(levels.float()).values
    thr = 0.5 * (lv[1:] + lv[:-1])
    idx = torch.searchsorted(thr, x.float().contiguous(), right=True)
    return lv[idx].to(x.dtype)


# ------------------------------------------------------ jax.random, in torch
def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (threefry, partitionable): subkey i is
    threefry(key, (0, i)), i.e. ``fold_in(key, i)``.  Returns (num, 2)."""
    return prng.fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


def randint(key: torch.Tensor, shape: tuple, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` of int32 values in [minval, maxval), for
    0 ≤ minval < maxval < 2^31: two 32-bit draws (one per half of
    ``split``), combined modulo the span in uint32 arithmetic as jax does."""
    n = 1
    for d in shape:
        n *= d
    k1, k2 = split(key)
    hi, lo = prng.random_bits(k1, n), prng.random_bits(k2, n)
    span = maxval - minval
    mult = (2**16 % span) ** 2 % span
    off = (((hi % span) * mult) & prng.MASK) + (lo % span)
    off = (off & prng.MASK) % span
    return (minval + off).reshape(shape)


def uniform(key: torch.Tensor, n: int, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform`` of n f32 values in [minval, maxval) as XLA
    computes it on the CPU: ``floats · (maxval − minval) + minval`` fused
    into one multiply-add (one rounding), here in f64 then rounded once
    (the f32 product is exact in f64).  ``prng.uniform`` rounds twice."""
    bits = prng.random_bits(key, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, (floats.double() * span.double() + lo.double()).float())


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ceil(3·ln n / ln(2^32 − 1))
    rounds, each a sort of the indices by 32 fresh random bits (stable
    here; XLA's sort is not, so the two orders can part only where two of
    the n keys of a round are equal)."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1)))
    for _ in range(rounds):
        key, sub = split(key)
        bits = prng.random_bits(sub, n)
        x = x[torch.argsort(bits, stable=True)]
    return x


def kmeanspp_seeds(blocks: torch.Tensor, n_seeds: int, key: torch.Tensor) -> torch.Tensor:
    """K-means++ (D²-sampling) seeds over block vectors (N_b, L_b) under the
    reference's ``jax.random`` key → (n_seeds, L_b)."""
    nb, lb = blocks.shape
    blocks = blocks.float()
    k0, key = split(key)
    first = blocks[randint(k0, (), 0, nb)]
    seeds = torch.zeros((n_seeds, lb), dtype=torch.float32, device=blocks.device)
    seeds[0] = first
    d2 = ((blocks - first) ** 2).sum(-1)
    for i in range(1, n_seeds):
        key, kd = split(key)
        p = d2 / torch.clamp_min(d2.sum(), 1e-12)
        nxt = blocks[prng.categorical(kd, torch.log(p + 1e-20))[0]]
        seeds[i] = nxt
        d2 = torch.minimum(d2, ((blocks - nxt) ** 2).sum(-1))
    return seeds
