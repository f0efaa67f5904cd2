"""Dense-model primitives of the port: norms, RoPE, quantized dense, paged
GQA attention, MLPs, and the bf16 / int8 / packed-BCQ4 KV page layouts.

Counterpart of the dense subset of ``repro/models/layers.py``.  Apply
functions take plain dicts of tensors (the reference's parameter tree
layout).  Where the reference is functional, the page writes here update
the page pool **in place** (``paged_token_write``, ``paged_chunk_write``):
the pool is the one large mutable state of a server.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import bcq, formats
from repro_torch.core.bcq import BCQConfig


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Static per-run model configuration.

    quant_mode: ``none`` (float weights); ``fake`` (W4A4 serving as the
    reference's default: weights fake-quantized offline by
    ``ptq.quantize_params``, activations quantized on the fly per
    ``act_format``); ``fake_full`` (the weights quantized in the forward
    too, on every call); ``packed`` (weights stored as packed 4-bit
    buffers; activations LO-BCQ-encoded on the fly).  act_format: the
    activation quantizer of the fake modes — ``bcq`` (the paper's; on the
    card through the quantize kernel, ``bcq.fake_quant``), the baselines
    ``mx4`` / ``mxfp4`` / ``vsq`` / ``int4`` (``core/baselines.py``), or
    ``none`` (W4A16, Table 4).
    fused_linear: packed linears go through the fused kernel
    (kernels/bcq_linear.py) instead of decode + matmul.  paged_kernel:
    paged attention goes through the page-gather kernel
    (kernels/common.py) instead of gather + dequant + masked softmax, and
    bcq4 pages are written by the page-store form of the encode kernel
    (kernels/bcq_quantize.py) instead of ``bcq.encode`` + scatter.
    flash_kernel: causal self-attention without a cache (the training /
    evaluation forward) goes through the flash kernel
    (kernels/flash_attention.py) instead of the masked softmax.
    logit_chunk: the loss takes its logits this many positions at a time
    (0: all at once).  quant_probe: the quant-error probe's recorder
    (``serving.telemetry.QuantProbeRecorder``), None for no probe."""

    quant_mode: str = "none"
    bcq_cfg: BCQConfig = BCQConfig()
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    cache_kind: str = "bf16"  # bf16 | int8 | bcq4
    paged_kernel: bool = False
    fused_linear: bool = True
    flash_kernel: bool = False
    logit_chunk: int = 0
    act_format: str = "bcq"  # bcq | mx4 | mxfp4 | vsq | int4 | none
    quant_probe: Any = None


QUANT_MODES = ("none", "fake", "fake_full", "packed")
ACT_FORMATS = ("bcq", "mx4", "mxfp4", "vsq", "int4", "none")


# ------------------------------------------------------------------ norms
def norm_apply(x, p, kind="rmsnorm", eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "nbias" in p:
        y = y + p["nbias"].float()
    return y.to(x.dtype)


# ------------------------------------------------------- quantized dense
def decode_packed_weight(pk: dict, cfg: BCQConfig, cb: torch.Tensor) -> torch.Tensor:
    """Dequantize a packed (..., N, K) weight to f32 (the unfused path); an
    expert stack's ``s_x`` is (E,), one per expert."""
    idx = bcq.unpack_nibbles(pk["idx"]).long()
    k = idx.shape[-1]
    sel = bcq.unpack_nibbles(pk["sel"]).long()[..., : k // cfg.block_len]
    ratio = formats.bits_to_e4m3(pk["scale"])
    vals = cb.reshape(-1)[torch.repeat_interleave(sel, cfg.block_len, -1) * cfg.n_entries + idx]
    s_x = pk["s_x"]
    s_x = s_x.reshape(s_x.shape + (1,) * (ratio.ndim - s_x.ndim))
    inv = torch.repeat_interleave(1.0 / (ratio * s_x), cfg.array_len, -1)
    return vals * inv


def fused_packed_linear(x, pk: dict, rt: Runtime, cb, s_x=None):
    """quant_mode='packed' linear through the fused kernel
    (ops.w4a4_linear_fused).  x: (..., K); pk: pack_weight dict (N, K)."""
    from repro_torch.kernels import ops

    return ops.w4a4_linear_fused(x, ops.packed_operand(pk), cb, rt.bcq_cfg, s_x=s_x)


def fused_packed_experts(xe, pk: dict, rt: Runtime, cb, s_x):
    """The packed expert GEMMs of a MoE layer through the fused kernel's
    expert-stacked form (ops.w4a4_linear_fused_experts): xe (E, C, K)
    against the stack pk (E, N, K), one shared ``s_x``."""
    from repro_torch.kernels import ops

    return ops.w4a4_linear_fused_experts(xe, ops.packed_operand(pk), cb, rt.bcq_cfg, s_x=s_x)


def pack_weight(w: torch.Tensor, cfg: BCQConfig, cb: torch.Tensor) -> dict:
    """Offline PTQ: (K, N) kernel → packed dict (blocks along K)."""
    enc = bcq.encode(w.T.float().contiguous(), cb, cfg)
    return {"idx": enc.packed_idx, "sel": enc.packed_sel, "scale": enc.scale_code,
            "s_x": enc.s_x}


def packed_weight_shapes(d_in: int, d_out: int, cfg: BCQConfig) -> dict:
    """(shape, dtype) of each buffer of a packed (d_in → d_out) kernel."""
    n, k = d_out, d_in
    return {
        "idx": ((n, k // 2), torch.uint8),
        "sel": ((n, k // (2 * cfg.block_len)), torch.uint8),
        "scale": ((n, k // cfg.array_len), torch.uint8),
        "s_x": ((), torch.float32),
    }


def _quantize_act(x, rt: Runtime, cb, plain: bool = False):
    """On-the-fly activation quantization per ``rt.act_format`` ('none' is
    weight-only W4A16).  ``plain`` keeps the BCQ encode off the kernel:
    the packed modes' unfused path is the fused kernel's plain version."""
    if rt.act_format == "none":
        return x
    if rt.act_format == "bcq":
        fq = bcq.fake_quant_plain if plain else bcq.fake_quant
        return fq(x, cb, rt.bcq_cfg)
    from repro_torch.core import baselines as B

    fn = {
        "mx4": B.mx_quantize,
        "mxfp4": B.mxfp4_quantize,
        "vsq": B.vsq_quantize,
        "int4": lambda v: B.int_pertensor(v, 4),
    }[rt.act_format]
    return fn(x)


def _emit_quant_probe(x, rt: Runtime, cb, tag) -> None:
    """Report the activation-quant error at one GEMM site: the encode stats
    of the RAW activation x (..., K) — the x the site's linear encodes, all
    of the launch's rows — into the next row of the recorder's device
    buffer (``rt.quant_probe.record``).  In the W4A4 modes with the BCQ
    activation format (the other formats have no codebooks to occupy),
    at a tagged site; ``qdense_shared`` tags once for its head group, so
    the probe never double-counts."""
    if rt.quant_probe is None or tag is None or cb is None:
        return
    if rt.quant_mode not in ("fake", "fake_full", "packed") or rt.act_format != "bcq":
        return
    rt.quant_probe.record(tag, x.reshape(-1, x.shape[-1]), cb, rt.bcq_cfg)


def qdense_shared(x, ps: list, rt: Runtime, cb, tag=None):
    """Several linear heads over the SAME input (QKV, MLP wi/wg): quantize
    the activation once and reuse it; the fused kernel encodes the raw
    input itself (bit-identical: same x, same s_X), so the fused packed
    path, which implements the BCQ activation format only, skips the
    shared quantization.  ``tag`` names the group for the quant-error
    probe, emitted once here."""
    _emit_quant_probe(x, rt, cb, tag)
    if rt.quant_mode == "packed" and rt.fused_linear and rt.act_format == "bcq" and cb is not None:
        return [qdense(x, p, rt, cb) for p in ps]
    if rt.quant_mode in ("fake", "fake_full", "packed") and cb is not None:
        xq = _quantize_act(x.float(), rt, cb, plain=rt.quant_mode == "packed")
        return [qdense(xq, p, rt, cb, pre_quantized=True) for p in ps]
    return [qdense(x, p, rt, cb) for p in ps]


def _fake_full_weight(p, rt: Runtime, cb) -> torch.Tensor:
    """A (K, N) kernel fake-quantized in the forward (blocks along K, one
    s_X over the matrix), in compute dtype, as (N, K)."""
    return bcq.fake_quant(p["kernel"].float().T, cb, rt.bcq_cfg).to(rt.compute_dtype)


def qdense(x, p, rt: Runtime, cb, pre_quantized: bool = False, tag=None):
    """Linear layer honoring rt.quant_mode.  x: (..., K); kernel (K, N).
    ``pre_quantized``: x was quantized by ``qdense_shared``.  ``tag`` names
    the site for the quant-error probe."""
    if not pre_quantized:
        _emit_quant_probe(x, rt, cb, tag)
    dt = rt.compute_dtype
    if rt.quant_mode not in QUANT_MODES:
        raise ValueError(f"unknown quant_mode {rt.quant_mode!r}")
    if pre_quantized and rt.quant_mode != "none" and cb is not None:
        if rt.quant_mode == "fake":
            y = x.to(dt) @ p["kernel"].to(dt)
        elif rt.quant_mode == "fake_full":
            y = x.to(dt) @ _fake_full_weight(p, rt, cb).T
        else:
            w = decode_packed_weight(p["kernel_packed"], rt.bcq_cfg, cb).to(dt)
            y = x.to(dt) @ w.T
    elif rt.quant_mode == "none" or cb is None:
        y = x.to(dt) @ p["kernel"].to(dt)
    elif rt.quant_mode == "fake":
        # weights PTQ'd offline; only the activations quantize here
        y = _quantize_act(x.float(), rt, cb).to(dt) @ p["kernel"].to(dt)
    elif rt.quant_mode == "fake_full":
        y = _quantize_act(x.float(), rt, cb).to(dt) @ _fake_full_weight(p, rt, cb).T
    elif rt.fused_linear:
        y = fused_packed_linear(x, p["kernel_packed"], rt, cb).to(dt)
    else:
        xq = bcq.fake_quant_plain(x.float(), cb, rt.bcq_cfg).to(dt)
        y = xq @ decode_packed_weight(p["kernel_packed"], rt.bcq_cfg, cb).to(dt).T
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


# -------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) absolute indices."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


# -------------------------------------------------------------- KV caches
def _cache_cfg(cfg: BCQConfig, d_head: int) -> BCQConfig:
    """BCQ config for per-head-vector cache quantization: the array length
    shrinks to d_head when d_head < L_A (small smoke heads)."""
    if d_head % cfg.array_len == 0:
        return cfg
    la = min(cfg.array_len, d_head)
    if la % cfg.block_len or d_head % la:
        raise ValueError(f"d_head {d_head} does not fit the BCQ config {cfg}")
    return dataclasses.replace(cfg, array_len=la)


def cache_init(batch, seq, n_kv, d_head, kind, cfg: BCQConfig, dtype=torch.bfloat16,
               device="cpu"):
    """Empty cache leaves for ONE layer (a page pool is cache_init(n_pages,
    page_size, ...): batch axis = page, sequence axis = slot)."""
    def z(*shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind == "bf16":
        return {"k": z(batch, seq, n_kv, d_head, dt=dtype), "v": z(batch, seq, n_kv, d_head, dt=dtype)}
    if kind == "int8":
        return {
            "k": z(batch, seq, n_kv, d_head, dt=torch.int8),
            "v": z(batch, seq, n_kv, d_head, dt=torch.int8),
            "k_scale": z(batch, seq, n_kv, dt=torch.float32),
            "v_scale": z(batch, seq, n_kv, dt=torch.float32),
        }
    if kind == "bcq4":
        cfg = _cache_cfg(cfg, d_head)
        out = {}
        for nm in ("k", "v"):
            out[f"{nm}_idx"] = z(batch, seq, n_kv, d_head // 2, dt=torch.uint8)
            out[f"{nm}_sel"] = z(batch, seq, n_kv, d_head // (2 * cfg.block_len), dt=torch.uint8)
            out[f"{nm}_scale"] = z(batch, seq, n_kv, max(d_head // cfg.array_len, 1), dt=torch.uint8)
        out["k_sx"] = torch.ones((), dtype=torch.float32, device=device)
        out["v_sx"] = torch.ones((), dtype=torch.float32, device=device)
        return out
    raise ValueError(kind)


def _cache_quant_int8(x):
    s = x.float().abs().amax(dim=-1) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(x.float() / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def cache_encode(k_new, v_new, kind, cfg: BCQConfig, cb, sx: dict) -> dict:
    """Quantize (B, S, H, D) keys/values into cache-leaf layout (per
    (token, head) vector); ``sx`` holds the pool-global k_sx / v_sx."""
    if kind == "bf16":
        return {"k": k_new.to(torch.bfloat16), "v": v_new.to(torch.bfloat16)}
    if kind == "int8":
        kq, ks = _cache_quant_int8(k_new)
        vq, vs = _cache_quant_int8(v_new)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    if kind == "bcq4":
        cfg = _cache_cfg(cfg, k_new.shape[-1])
        out = {}
        for nm, val in (("k", k_new), ("v", v_new)):
            enc = bcq.encode(val.float(), cb, cfg, s_x=sx[f"{nm}_sx"])
            out[f"{nm}_idx"] = enc.packed_idx
            out[f"{nm}_sel"] = enc.packed_sel
            out[f"{nm}_scale"] = enc.scale_code
        return out
    raise ValueError(kind)


def cache_write(cache, k_new, v_new, pos: int, kind, cfg: BCQConfig, cb):
    """Insert (B, S_new, H, D) keys/values at sequence offset ``pos`` of a
    contiguous cache, IN PLACE (the slab prefill and the contiguous decode
    step).  As the reference's ``dynamic_update_slice``, the offset is
    clamped so that the update fits.  Returns the cache."""
    enc = cache_encode(k_new, v_new, kind, cfg, cb, cache)
    s = k_new.shape[1]
    for n, val in enc.items():
        leaf = cache[n]
        start = max(0, min(pos, leaf.shape[1] - s))
        leaf[:, start:start + s] = val.to(leaf.dtype)
    return cache


def cache_read(cache, kind, cfg: BCQConfig, cb, dtype, valid_len=None):
    """Dequantize cache leaves → (k, v) in ``dtype``.  ``valid_len`` bounds
    the read to the first ``valid_len`` sequence positions."""
    if valid_len is not None:
        cache = {n: (leaf[:, :valid_len] if leaf.ndim >= 2 else leaf) for n, leaf in cache.items()}
    if kind == "bf16":
        return cache["k"].to(dtype), cache["v"].to(dtype)
    if kind == "int8":
        k = cache["k"].float() * cache["k_scale"][..., None]
        v = cache["v"].float() * cache["v_scale"][..., None]
        return k.to(dtype), v.to(dtype)
    if kind == "bcq4":
        outs = []
        for nm in ("k", "v"):
            idx = bcq.unpack_nibbles(cache[f"{nm}_idx"]).long()
            d = idx.shape[-1]
            ccfg = _cache_cfg(cfg, d)
            sel = bcq.unpack_nibbles(cache[f"{nm}_sel"]).long()[..., : d // ccfg.block_len]
            ratio = formats.bits_to_e4m3(cache[f"{nm}_scale"])
            # unwritten slots hold ratio == 0 → decode to 0, not inf
            inv_r = torch.where(ratio > 0, 1.0 / (ratio * cache[f"{nm}_sx"]), torch.zeros_like(ratio))
            code = torch.repeat_interleave(sel, ccfg.block_len, -1) * ccfg.n_entries + idx
            vals = cb.reshape(-1)[code]
            outs.append((vals * torch.repeat_interleave(inv_r, ccfg.array_len, -1)).to(dtype))
        return outs[0], outs[1]
    raise ValueError(kind)


# ------------------------------------------------------- paged KV pages
def pool_page_size(pool: dict) -> int:
    """Page size (tokens) of a single-layer page-pool tree."""
    for leaf in pool.values():
        if leaf.ndim >= 2:
            return leaf.shape[1]
    raise ValueError("pool has no paged leaves")


def _last_writer(flat: torch.Tensor) -> torch.Tensor:
    """For each row i, the LAST row j with flat[j] == flat[i].

    Scattering ``src[_last_writer(ids)]`` makes every duplicate write the
    same value, so a duplicate scatter (idle rows all writing the null
    page) is deterministic with last-row-wins semantics — what the
    reference's XLA scatter does on CPU, and what ``index_put_`` on CUDA
    does not promise."""
    rows = torch.arange(flat.shape[0], device=flat.device)
    same = flat[:, None] == flat[None, :]
    return torch.where(same, rows[None, :], -1).amax(dim=1)


def paged_token_write(pool, k_new, v_new, page_ids, offsets, kind, cfg: BCQConfig, cb,
                      kernel: bool = False):
    """Quantize one new token per sequence and scatter it into its page,
    IN PLACE.  pool: single-layer page-pool tree, leaves (P, ps, H, ...);
    k_new/v_new: (B, 1, H, D); page_ids/offsets: (B,) page slot of each
    sequence's tail.  Rows sharing a slot (idle rows on the null page)
    resolve last row wins.  ``kernel``: bcq4 pages on the card are written
    by the page-store form of the encode kernel (kernels/bcq_quantize.py);
    CPU tensors take this plain version."""
    if kernel and kind == "bcq4" and k_new.device.type != "cpu":
        from repro_torch.kernels.bcq_quantize import bcq_page_write

        return bcq_page_write(pool, k_new, v_new, cfg, cb, page_ids=page_ids, offsets=offsets)
    enc = cache_encode(k_new, v_new, kind, cfg, cb, pool)
    ps = pool_page_size(pool)
    win = _last_writer(page_ids.long() * ps + offsets.long())
    for n, leaf in pool.items():
        if leaf.ndim < 2:
            continue  # per-tensor scales are pool-global
        leaf[page_ids.long(), offsets.long()] = enc[n][:, 0][win].to(leaf.dtype)
    return pool


def paged_chunk_write(pool, k_new, v_new, chunk_page_ids, kind, cfg: BCQConfig, cb,
                      chunk_len=None, kernel: bool = False):
    """Quantize a prefill chunk's K/V and scatter it whole-page into pool
    pages, IN PLACE.

    k_new/v_new: (B, C, H, D); chunk_page_ids: (B, n_cp) destination pages,
    n_cp = ceil(C/ps).  The chunk starts at a page boundary; positions
    past the chunk (and past each row's ``chunk_len`` when C is a padded
    bucket) write the all-zero ``cache_init`` state, so a padded row
    writes the same bytes as an exact-length one.  Duplicate destinations
    (the null page) resolve last write wins.  ``kernel`` as in
    ``paged_token_write``."""
    if kernel and kind == "bcq4" and k_new.device.type != "cpu":
        from repro_torch.kernels.bcq_quantize import bcq_page_write

        return bcq_page_write(pool, k_new, v_new, cfg, cb, chunk_page_ids=chunk_page_ids,
                              chunk_len=chunk_len)
    b, c = k_new.shape[:2]
    ps = pool_page_size(pool)
    n_cp = chunk_page_ids.shape[1]
    enc = cache_encode(k_new, v_new, kind, cfg, cb, pool)
    valid = torch.arange(n_cp * ps, device=k_new.device)[None, :] < (
        c if chunk_len is None else chunk_len.long()[:, None]
    )
    ids = chunk_page_ids.long().reshape(-1)
    win = _last_writer(ids)
    for n, leaf in pool.items():
        if leaf.ndim < 2:
            continue
        src = torch.zeros((b, n_cp * ps) + leaf.shape[2:], dtype=leaf.dtype, device=leaf.device)
        src[:, :c] = enc[n].to(leaf.dtype)
        src = torch.where(valid.reshape(valid.shape + (1,) * (src.ndim - 2)), src,
                          torch.zeros_like(src))
        pages = src.reshape((b * n_cp, ps) + leaf.shape[2:])
        leaf[ids] = pages[win]
    return pool


def paged_gather_kv(pool, block_tables, kind, cfg: BCQConfig, cb, dtype):
    """Gather each sequence's pages through its block table and dequantize:
    (k, v) of shape (B, MAXP·ps, H, D); positions past a row's length hold
    whatever the pages hold and must be masked by the caller."""
    gathered = {}
    bt = block_tables.long()
    for n, leaf in pool.items():
        if leaf.ndim < 2:
            gathered[n] = leaf
            continue
        g = leaf[bt]  # (B, MAXP, ps, ...)
        gathered[n] = g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])
    return cache_read(gathered, kind, cfg, cb, dtype)


# ---------------------------------------------------------------- attention
def _attend_chunked(q, k, v, q_pos, kv_valid_len, causal=True):
    """Exact softmax attention.  q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D);
    q_pos (B, Sq) absolute positions; kv index j is absolute position j.
    Masks: j < kv_valid_len, and j <= pos when causal, with finite -1e30.
    (The reference scans over query chunks to bound memory; rows are
    independent, so all rows at once give the same values.)"""
    d = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    kx = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    vx = torch.repeat_interleave(v, rep, dim=2) if rep > 1 else v
    s = torch.einsum("bchd,bkhd->bhck", q.float(), kx.float()) * d**-0.5
    j = torch.arange(k.shape[1], device=q.device)
    m = j[None, None, None, :] < kv_valid_len
    if causal:
        m = m & (j[None, None, None, :] <= q_pos[:, None, :, None])
    s = torch.where(m, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhck,bkhd->bchd", p, vx.float()).to(q.dtype)


def attention(x, p, cfg, rt: Runtime, cb, positions, paged=None, cache=None, cache_pos=None):
    """GQA attention: the cache-free self-attention, the contiguous-cache
    branch and the two paged serving branches of the reference.

    ``cache`` (one layer's contiguous cache, leaves (B, max_len, ...)) with
    ``cache_pos`` (int): the SLAB path — x's K/V are written at
    ``cache_pos`` (``cache_write``, in place) and x attends causally to
    the first ``cache_pos + S`` positions of the cache, the only ones the
    read dequantizes.  The reference uses no Pallas kernel
    here; its linears still go through the fused linear.
    ``paged`` = None and no cache: causal SELF-ATTENTION over x alone (the
    training / evaluation forward) — through the flash kernel when
    ``rt.flash_kernel``, else the masked softmax.
    ``paged`` = (pool, block_tables, lengths): DECODE — the new token is
    written into its page, attention reads live pages only.
    ``paged`` = (pool, block_tables, n_past, chunk_page_ids[, chunk_len]):
    CHUNKED PREFILL — x is a prompt chunk starting at page-aligned
    ``n_past``; its K/V are written whole-page into ``chunk_page_ids`` and
    the chunk attends causally to itself and every earlier page.
    Returns (out, pool or cache) — updated in place (None without one)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q, k, v = qdense_shared(x, [p["wq"], p["wk"], p["wv"]], rt, cb, tag="attn_qkv")
    q = rope(q.reshape(b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    kind = rt.cache_kind

    if cache is not None:
        pool = cache_write(cache, k, v, cache_pos, kind, rt.bcq_cfg, cb)
        kf, vf = cache_read(cache, kind, rt.bcq_cfg, cb, rt.compute_dtype, valid_len=cache_pos + s)
        out = _attend_chunked(q, kf, vf, positions, cache_pos + s)
    elif paged is None:
        pool = None
        if rt.flash_kernel:  # causal, no window, as many keys as queries
            from repro_torch.kernels.flash_attention import flash_attention

            out = flash_attention(q, k, v, causal=True).to(q.dtype)
        else:
            out = _attend_chunked(q, k, v, positions, k.shape[1])
    elif len(paged) >= 4:
        pool, block_tables, n_past, chunk_page_ids = paged[:4]
        chunk_len = paged[4] if len(paged) == 5 else None
        paged_chunk_write(pool, k, v, chunk_page_ids, kind, rt.bcq_cfg, cb, chunk_len,
                          kernel=rt.paged_kernel)
        if rt.paged_kernel:
            from repro_torch.kernels.chunked_prefill import chunked_prefill

            out = chunked_prefill(q, pool, block_tables, n_past, kind, rt.bcq_cfg, cb).to(q.dtype)
        else:
            kf, vf = paged_gather_kv(pool, block_tables, kind, rt.bcq_cfg, cb, rt.compute_dtype)
            out = _attend_chunked(q, kf, vf, positions, (n_past + s).reshape(b, 1, 1, 1))
    else:
        pool, block_tables, lengths = paged
        ps = pool_page_size(pool)
        rows = torch.arange(b, device=x.device)
        page_ids = block_tables.long()[rows, lengths.long() // ps]
        paged_token_write(pool, k, v, page_ids, lengths % ps, kind, rt.bcq_cfg, cb,
                          kernel=rt.paged_kernel)
        valid = lengths + s
        if rt.paged_kernel and s == 1:
            from repro_torch.kernels.paged_attention import paged_attention

            out = paged_attention(q[:, 0], pool, block_tables, valid, kind, rt.bcq_cfg, cb)
            out = out.to(q.dtype)[:, None]
        else:
            kf, vf = paged_gather_kv(pool, block_tables, kind, rt.bcq_cfg, cb, rt.compute_dtype)
            out = _attend_chunked(q, kf, vf, positions, valid.reshape(b, 1, 1, 1))
    out = qdense(out.reshape(b, s, cfg.n_heads * hd), p["wo"], rt, cb, tag="attn_out")
    return out, pool


# ------------------------------------------------------------------- MLPs
def mlp(x, p, act, rt: Runtime, cb):
    if act == "swiglu":
        h, g = qdense_shared(x, [p["wi"], p["wg"]], rt, cb, tag="mlp_in")
        h = torch.nn.functional.silu(g.float()).to(h.dtype) * h
    else:
        h = qdense(x, p["wi"], rt, cb, tag="mlp_in")
        # jax.nn.gelu defaults to the tanh approximation
        h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(h.dtype)
    return qdense(h, p["wo"], rt, cb, tag="mlp_out")
