"""Shared pieces of the port's LO-BCQ kernels, and the page-gather core.

Counterpart of ``repro/kernels/common.py``:

* plain helpers — nibble packing (``pack_u4`` / ``unpack_u4``), the E4M3
  snap (``e4m3_snap``), the threshold-compare encode of one tile
  (``encode_tile``, the plain version of the encode inside
  csrc/bcq_linear.cu) and the per-page dequant (``dequant_page``);
* the **page-gather attention core** shared by paged decode (C == 1,
  kernels/paged_attention.py) and chunked prefill (C > 1,
  kernels/chunked_prefill.py): ``page_gather_attention`` launches the
  CUDA kernels (csrc/page_gather.cu: a row's pages split into groups of
  ``SPLIT_PAGES``, one block each, then a combine of the splits' partial
  softmax states in ascending split order) for CUDA tensors and runs
  ``page_gather_attention_plain`` for CPU tensors; meta tensors (the
  dry-run) get a meta output and ``gather_cost``'s count.

Semantics of the core (``repro/kernels/common.py:236-262``, ``:330-371``):
query c of row b sits at ``kv_len[b] - C + c`` and sees page token t iff
``t <= qpos`` under the finite mask ``NEG``; each row walks
``clip(ceil(kv_len/ps), 1, MAXP)`` pages of its table (at least one, so a
zero-length row still produces finite output); the result is
``acc / max(l, 1e-30)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bcq import (BCQConfig, block_sq_err, check_kernel_format, codeword_over,
                                  kernel_route, unpack_nibbles)
from repro_torch.core.formats import bits_to_e4m3, pow2
from repro_torch.kernels import build

NEG = -1e30

_E4M3_MAX = 448.0
_E4M3_MIN_SUB = 2.0**-9

PAGE_GATHER = build.counter("page_gather")
# the C entry's kinds: bcq4 in the default format (2) or in any other (3)
_KIND_CODE = {"bf16": 0, "int8": 1, "bcq4": 2, "bcq4_fmt": 3}
# Pages per split of the CUDA page gather: fixed, so a row's result depends
# on its own pages only (not on the batch or the grid).
SPLIT_PAGES = 8


def e4m3_snap(a: torch.Tensor) -> torch.Tensor:
    """E4M3 round-to-nearest for positive values, clamped to [2^-9, 448]."""
    e = torch.floor(torch.log2(torch.clamp_min(a, 1e-38))).clamp(-6.0, 8.0)
    ulp = pow2(e - 3.0)
    q = torch.round(a / ulp) * ulp
    q = torch.clamp_max(q, _E4M3_MAX)
    return torch.clamp_min(q, _E4M3_MIN_SUB)


def pack_u4(x: torch.Tensor) -> torch.Tensor:
    """(T, 2n) uint values < 16 → (T, n) packed uint8, low nibble first."""
    x = x.to(torch.uint8)
    return (x[:, 1::2] << 4) | x[:, 0::2]


def unpack_u4(p: torch.Tensor) -> torch.Tensor:
    """(T, n) packed uint8 → (T, 2n) int64 nibbles, low nibble first."""
    t, n = p.shape
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(t, n * 2).long()


def encode_tile(x: torch.Tensor, cb: torch.Tensor, s_x: torch.Tensor, cfg: BCQConfig):
    """LO-BCQ encode of an (M, K) f32 tile by threshold compares.

    Per array: amax → ŝ_A = e4m3_snap(s_A/s_X); per codebook: the nearest
    sorted entry per scalar by 2^B−1 compares, the block error summed left
    to right, a strict-< running argmin over codebooks.  The plain version
    of the encode inside csrc/bcq_linear.cu (same order of operations).
    Returns (idx (M, K) int64, sel (M, K/L_b) int64, ratio (M, K/L_A) f32)."""
    tm, tk = x.shape
    la, lb = cfg.array_len, cfg.block_len
    arrays = x.reshape(tm, tk // la, la)
    amax = arrays.abs().amax(dim=-1)
    s_a = torch.where(amax > 0, codeword_over(amax, cfg), s_x)
    ratio = e4m3_snap(s_a / s_x)
    y = arrays * (ratio * s_x)[..., None]
    blocks = y.reshape(tm, tk // lb, lb)

    best_err = torch.full(blocks.shape[:-1], float("inf"), device=x.device)
    best_sel = torch.zeros(blocks.shape[:-1], dtype=torch.int64, device=x.device)
    best_idx = torch.zeros(blocks.shape, dtype=torch.int64, device=x.device)
    for i in range(cfg.n_codebooks):
        thr = 0.5 * (cb[i, 1:] + cb[i, :-1])
        idx = torch.zeros(blocks.shape, dtype=torch.int64, device=x.device)
        for t in range(cfg.n_entries - 1):
            idx += blocks >= thr[t]
        err = block_sq_err(blocks - cb[i][idx])
        take = err < best_err
        best_err = torch.where(take, err, best_err)
        best_sel = torch.where(take, i, best_sel)
        best_idx = torch.where(take[..., None], idx, best_idx)
    return best_idx.reshape(tm, tk), best_sel, ratio


# ===================================================================== #
#  Page-gather attention core (paged decode + chunked prefill)          #
# ===================================================================== #
def page_pool_leaves(pool: dict, kind: str) -> tuple[list, list]:
    """The (k_leaves, v_leaves) of a single-layer page pool, in the order
    the page-gather kernel consumes them."""
    if kind == "bf16":
        return [pool["k"]], [pool["v"]]
    if kind == "int8":
        return [pool["k"], pool["k_scale"]], [pool["v"], pool["v_scale"]]
    if kind == "bcq4":
        return (
            [pool["k_idx"], pool["k_sel"], pool["k_scale"]],
            [pool["v_idx"], pool["v_sel"], pool["v_scale"]],
        )
    raise ValueError(kind)


def page_cfg(cfg: BCQConfig, d: int) -> BCQConfig:
    """bcq4 pages quantize per head vector: L_A shrinks to d_head when
    d_head is not a multiple of it (``common.py:406-408``)."""
    if d % cfg.array_len:
        return dataclasses.replace(cfg, array_len=min(cfg.array_len, d))
    return cfg


def dequant_page(kind: str, leaves: list, cfg: BCQConfig, cb, sx) -> torch.Tensor:
    """Dequantize gathered page leaves (..., ps, Hkv, ·) to f32 (..., ps, Hkv, D).

    bcq4 looks the codeword up in the flattened codebook table (the TPU
    kernel's one-hot matmul is an exact stand-in for this gather)."""
    if kind == "bf16":
        return leaves[0].float()
    if kind == "int8":
        return leaves[0].float() * leaves[1][..., None]
    idx = unpack_nibbles(leaves[0]).long()
    d = idx.shape[-1]
    cfg = page_cfg(cfg, d)
    sel = unpack_nibbles(leaves[1]).long()[..., : d // cfg.block_len]
    ratio = bits_to_e4m3(leaves[2])
    inv = torch.where(ratio > 0, 1.0 / (ratio * sx), torch.zeros_like(ratio))
    code = torch.repeat_interleave(sel, cfg.block_len, dim=-1) * cfg.n_entries + idx
    vals = cb.reshape(-1)[code]
    return vals * torch.repeat_interleave(inv, cfg.array_len, dim=-1)


def page_gather_attention_plain(q, pool, block_tables, kv_len, kind, cfg, cb=None):
    """Plain PyTorch page-gather attention: the kernel's semantics as one
    masked softmax over the tokens of each row's first
    ``clip(ceil(kv_len/ps), 1, MAXP)`` pages (the kernel's online softmax
    over the same pages, in exact arithmetic).  q (B, C, H, D) → f32."""
    b, c, h, d = q.shape
    kl, vl = page_pool_leaves(pool, kind)
    ps, hkv = kl[0].shape[1], kl[0].shape[2]
    maxp = block_tables.shape[1]
    rep = h // hkv
    bt = block_tables.long()
    sx_k = pool.get("k_sx")
    sx_v = pool.get("v_sx")
    kf = dequant_page(kind, [leaf[bt] for leaf in kl], cfg, cb, sx_k)
    vf = dequant_page(kind, [leaf[bt] for leaf in vl], cfg, cb, sx_v)
    kf = kf.reshape(b, maxp * ps, hkv, d)
    vf = vf.reshape(b, maxp * ps, hkv, d)
    qg = q.float().reshape(b, c, hkv, rep, d)
    s = torch.einsum("bcgrd,btgd->bgrct", qg, kf) * d**-0.5
    kvl = kv_len.long()
    steps = ((kvl + ps - 1) // ps).clamp(1, maxp)  # (B,)
    tpos = torch.arange(maxp * ps, device=q.device)
    qpos = kvl[:, None] - c + torch.arange(c, device=q.device)  # (B, C)
    visible = tpos[None, None, :] <= qpos[:, :, None]  # (B, C, T)
    walked = tpos[None, :] < (steps * ps)[:, None]  # (B, T)
    s = torch.where(visible[:, None, None], s, NEG)
    s = torch.where(walked[:, None, None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrct,btgd->bcgrd", p, vf)
    return out.reshape(b, c, h, d)


def gather_cost(kind: str, q, k_leaves: list, block_tables, kv_len=None,
                cfg: BCQConfig = BCQConfig()) -> tuple:
    """(HBM bytes, operations by unit) of the page gather: q read and out
    written in f32, each walked K and V page read once, the tables and
    lengths read; QK and PV of every query head over its causally visible
    keys on the CUDA cores.  ``kv_len`` (a list of ints) counts the pages
    and keys that data walks; None counts every row at its table's full
    length (the most the call can need: the dry-run's meta lengths)."""
    b, c, h, d = q.shape
    ps, hkv = k_leaves[0].shape[1:3]
    maxp = block_tables.shape[1]
    lens = [maxp * ps] * b if kv_len is None else kv_len
    page_bytes = sum(ps * leaf[0, 0].numel() * leaf.element_size() for leaf in k_leaves)
    pages = sum(min(max(1, -(-n // ps)), maxp) for n in lens)
    nbytes = (2 * q.numel() * 4 + 2 * pages * page_bytes + block_tables.numel() * 4 + b * 4
              + (build.codebook_bytes(cfg) + 8 if kind == "bcq4" else 0))
    seen = sum(n - c + i + 1 for n in lens for i in range(c))  # (query, key) pairs, causal
    return nbytes, {"f32": 4 * h * d * seen}


def page_gather_attention(q, pool, block_tables, kv_len, kind, cfg, cb=None):
    """The shared page-gather attention over one layer's page pool.

    q: (B, C, H, D) queries — query c of row b sits at absolute position
    ``kv_len[b] - C + c``; pool leaves (P, ps, Hkv, ...) per ``cache_init``
    layout; block_tables (B, MAXP) int32; kv_len (B,) int32.  Returns
    (B, C, H, D) f32.  CPU tensors run the plain version; CUDA tensors
    launch csrc/page_gather.cu (split kernel and combine, counted as one
    launch of the page gather) or raise."""
    if q.device.type == "cpu":
        return page_gather_attention_plain(q, pool, block_tables, kv_len, kind, cfg, cb)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"page_gather_attention: unsupported device {q.device}")
    b, c, h, d = q.shape
    kl, vl = page_pool_leaves(pool, kind)
    p_, ps, hkv = kl[0].shape[:3]
    maxp = block_tables.shape[1]
    la = page_cfg(cfg, d).array_len if kind == "bcq4" else d
    if h % hkv or ps > 32 or d > 128 or d % 16 or d % la:
        raise ValueError(f"page_gather kernel: unsupported shape H={h} Hkv={hkv} ps={ps} D={d}")
    code = _KIND_CODE[kind]
    if kind == "bcq4":
        check_kernel_format(page_cfg(cfg, d), "page_gather kernel")
        if not kernel_route(page_cfg(cfg, d)).special:
            code = _KIND_CODE["bcq4_fmt"]  # up to 8 arrays a head vector
    expect = {
        "bf16": [(torch.bfloat16, d)],
        "int8": [(torch.int8, d), (torch.float32, None)],
        "bcq4": [(torch.uint8, d // 2), (torch.uint8, d // (2 * cfg.block_len)),
                 (torch.uint8, d // la)],
    }[kind]
    for leaves in (kl, vl):
        for leaf, (dt, last) in zip(leaves, expect):
            want = (p_, ps, hkv) + (() if last is None else (last,))
            if leaf.device != q.device or leaf.dtype != dt or tuple(leaf.shape) != want:
                raise ValueError(
                    f"page_gather kernel: pool leaf {tuple(leaf.shape)} {leaf.dtype} "
                    f"on {leaf.device}, expected {want} {dt} on {q.device}"
                )
            if not leaf.is_contiguous():
                raise ValueError("page_gather kernel: pool leaves must be contiguous")
    if q.device.type == "meta":
        if tuple(block_tables.shape) != (b, maxp) or tuple(kv_len.shape) != (b,):
            raise ValueError("page_gather kernel: block_tables (B, MAXP) and kv_len (B,) expected")
        lens = None if kv_len.device.type == "meta" else kv_len.tolist()
        build.add_meta_cost("page_gather", *gather_cost(kind, q, kl, block_tables, lens, cfg))
        return torch.empty((b, c, h, d), dtype=torch.float32, device="meta")
    kl[0], vl[0] = build.aligned(kl[0], 16), build.aligned(vl[0], 16)  # copied by 16-byte chunks
    qf = q.float().contiguous()
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    kvl = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    if bt.shape != (b, maxp) or kvl.shape != (b,):
        raise ValueError("page_gather kernel: block_tables (B, MAXP) and kv_len (B,) expected")
    out = torch.empty((b, c, h, d), dtype=torch.float32, device=q.device)
    n_split = -(-maxp // SPLIT_PAGES)
    part = torch.empty((b * c * h * n_split * (d + 2),), dtype=torch.float32, device=q.device)
    k_ptrs = [leaf.data_ptr() for leaf in kl] + [None] * (3 - len(kl))
    v_ptrs = [leaf.data_ptr() for leaf in vl] + [None] * (3 - len(vl))
    if kind == "bcq4":
        sxk = pool["k_sx"].to(device=q.device, dtype=torch.float32).contiguous()
        sxv = pool["v_sx"].to(device=q.device, dtype=torch.float32).contiguous()
        cbf = cb.to(device=q.device, dtype=torch.float32).contiguous()
        if tuple(cbf.shape) != (cfg.n_codebooks, cfg.n_entries):
            raise ValueError(f"page_gather kernel: codebooks {tuple(cbf.shape)}, expected "
                             f"{(cfg.n_codebooks, cfg.n_entries)}")
        extra = (sxk.data_ptr(), sxv.data_ptr(), cbf.data_ptr())
    else:
        extra = (None, None, None)
    status = build.library().page_gather_launch(
        code, qf.data_ptr(), *k_ptrs, *v_ptrs, *extra, bt.data_ptr(),
        kvl.data_ptr(), out.data_ptr(), part.data_ptr(), b, c, h, hkv, d, ps, maxp, la,
        SPLIT_PAGES, d**-0.5, cfg.block_len, cfg.n_codebooks, cfg.n_entries,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(status, "page_gather_launch")
    PAGE_GATHER.count += 1
    return out
