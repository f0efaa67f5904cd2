"""RecurrentGemma/Griffin-style hybrid: RG-LRU recurrent blocks + local
sliding-window attention in a 1:2 pattern (arXiv:2402.19427); the
counterpart of ``repro/models/hybrid.py``.

The layers run by *period* (rec, rec, attn) — 12 periods + 2 tail
recurrent blocks for the 38-layer 9B config — a Python loop over views of
the period-stacked parameters and caches.  Decode uses a ring-buffer
window cache (window-sized at any sequence length) and an O(1) LRU state.
The input, gate and output projections are GEMMs and follow
``rt.quant_mode`` (``packed``: the fused W4A4 linear, B1 on the card);
the elementwise LRU recurrence, the causal conv, the ring's encode and
its masked attention have no weight GEMM and stay plain f32 PyTorch, as
the reference keeps them in plain ``jnp``.

Parameters are the reference's tree: ``periods/b{i}`` with a leading
period axis, ``tail{t}`` without one.  The decode cache
(``hybrid_cache_init``) is the reference's tree too: ``periods/b{i}`` of a
recurrent block holds ``lru_state`` (P, B, W) and ``conv_state`` (P, B, 3,
W), of an attention block the ring's cache leaves (P, B, window, ...), its
per-tensor ``k_sx`` / ``v_sx`` (P,) (bcq4) and ``pos_buf`` (P, B, window)
int32; the tails hold (B, ...) states.  ``prefill`` and ``decode_step``
write it in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, transformer
from repro_torch.models.layers import Runtime
from repro_torch.models.ssm import _softplus

_C = 8.0  # RG-LRU temperature


# ------------------------------------------------------------------- init
def _normal(g: torch.Generator, shape, scale=None, dtype=torch.float32) -> torch.Tensor:
    """The reference's ``layers.uinit``: normal · scale, the scale
    1/sqrt(shape[0]) unless given, drawn on ``g``'s device."""
    scale = scale if scale is not None else (1.0 / max(shape[0], 1)) ** 0.5
    return (torch.randn(shape, generator=g, device=g.device) * scale).to(dtype)


def _dense(g, d_in: int, d_out: int, rt: Runtime, bias: bool = False) -> dict:
    p = {"kernel": _normal(g, (d_in, d_out), dtype=rt.param_dtype)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=rt.param_dtype, device=g.device)
    return p


def _mlp(g, cfg: ArchConfig, rt: Runtime) -> dict:
    p = {"wi": _dense(g, cfg.d_model, cfg.d_ff, rt), "wo": _dense(g, cfg.d_ff, cfg.d_model, rt)}
    if cfg.act == "swiglu":
        p["wg"] = _dense(g, cfg.d_model, cfg.d_ff, rt)
    return p


def init_rec_block(cfg: ArchConfig, rt: Runtime, g: torch.Generator) -> dict:
    """One RG-LRU block's float parameters with the reference's shapes and
    scales: linears normal · 1/sqrt(d_in), the conv kernel 0.5, ``lru_a``
    normal (f32), norms at scale 1."""
    w = cfg.hybrid.lru_width or cfg.d_model
    dev = g.device
    return {
        "ln": transformer._norm(cfg, rt, (), dev),
        "proj_x": _dense(g, cfg.d_model, w, rt),
        "proj_gate": _dense(g, cfg.d_model, w, rt),
        "conv_kernel": _normal(g, (4, w), scale=0.5, dtype=rt.param_dtype),
        "gate_a": _dense(g, w, w, rt),
        "gate_x": _dense(g, w, w, rt),
        "lru_a": _normal(g, (w,), scale=1.0),
        "proj_out": _dense(g, w, cfg.d_model, rt),
        "ln_mlp": transformer._norm(cfg, rt, (), dev),
        "mlp": _mlp(g, cfg, rt),
    }


def init_attn_block(cfg: ArchConfig, rt: Runtime, g: torch.Generator) -> dict:
    """One local-attention block's float parameters (GQA projections,
    the norms, the MLP)."""
    hd, dev = cfg.head_dim, g.device
    return {
        "ln": transformer._norm(cfg, rt, (), dev),
        "attn": {
            "wq": _dense(g, cfg.d_model, cfg.n_heads * hd, rt, cfg.qkv_bias),
            "wk": _dense(g, cfg.d_model, cfg.n_kv_heads * hd, rt, cfg.qkv_bias),
            "wv": _dense(g, cfg.d_model, cfg.n_kv_heads * hd, rt, cfg.qkv_bias),
            "wo": _dense(g, cfg.n_heads * hd, cfg.d_model, rt),
        },
        "ln_mlp": transformer._norm(cfg, rt, (), dev),
        "mlp": _mlp(g, cfg, rt),
    }


def init_period(cfg: ArchConfig, rt: Runtime, g: torch.Generator) -> dict:
    """One period's blocks ``b{i}`` (no period axis), drawn in pattern order."""
    return {f"b{i}": (init_attn_block if kind == "attn" else init_rec_block)(cfg, rt, g)
            for i, kind in enumerate(cfg.hybrid.pattern)}


# ----------------------------------------------------------- RG-LRU block
def _combine(al, ul, ar, ur):
    """The scan's operator on (a, u) pairs: (al·ar, ur + ar·ul)."""
    return al * ar, ur + ar * ul


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], … along axis 1."""
    shape = list(even.shape)
    shape[1] = even.shape[1] + odd.shape[1]
    out = torch.empty(shape, dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a: torch.Tensor, u: torch.Tensor):
    """``jax.lax.associative_scan(_combine, (a, u), axis=1)`` with its
    association: combine adjacent pairs, scan those recursively, combine
    the odd prefixes with the even elements, interleave — O(log S) levels
    of launches, each element's sum associated as the reference's."""
    n = a.shape[1]
    if n < 2:
        return a, u
    ra, ru = _combine(a[:, 0:-1:2], u[:, 0:-1:2], a[:, 1::2], u[:, 1::2])
    oa, ou = _scan(ra, ru)
    if n % 2 == 0:
        ea, eu = _combine(oa[:, :-1], ou[:, :-1], a[:, 2::2], u[:, 2::2])
    else:
        ea, eu = _combine(oa, ou, a[:, 2::2], u[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eu = torch.cat([u[:, :1], eu], dim=1)
    return _interleave(ea, oa), _interleave(eu, ou)


def _lru_scan(a, u, state=None):
    """h_t = a_t ⊙ h_{t-1} + u_t along axis 1.  a, u: (B, S, W); state:
    (B, W) initial or None.  At S = 1 this is u + a · state."""
    if state is not None:
        u = torch.cat([(u[:, 0] + a[:, 0] * state)[:, None], u[:, 1:]], dim=1)
    return _scan(a, u)[1]


def _conv(x, kernel, state=None):
    """Depthwise causal conv of width K over x (B, S, W), the taps summed
    left to right from tap 0; ``state`` (B, K−1, W) history or None
    (zeros).  Returns (out f32, the new state: the last K−1 input rows)."""
    k = kernel.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=torch.float32, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x.float()], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * kernel[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * kernel[i][None, None, :]
    return out, xp[:, xp.shape[1] - (k - 1):, :]


def rec_block(x, p, cfg: ArchConfig, rt: Runtime, cb, cache=None):
    """One RG-LRU block.  ``cache`` {'lru_state' (B, W), 'conv_state' (B, 3,
    W)}: the states the block starts from, overwritten in place with the
    states it ends in.  Returns the block's output."""
    h = layers.norm_apply(x, p["ln"], cfg.norm)
    xw, gate_pre = layers.qdense_shared(h, [p["proj_x"], p["proj_gate"]], rt, cb)
    # jax.nn.gelu defaults to the tanh approximation
    gate = torch.nn.functional.gelu(gate_pre.float(), approximate="tanh")
    conv_state = cache["conv_state"] if cache is not None else None
    xc, new_conv = _conv(xw, p["conv_kernel"].float(), conv_state)
    r_pre, i_pre = layers.qdense_shared(xc.to(rt.compute_dtype), [p["gate_a"], p["gate_x"]],
                                        rt, cb)
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    log_a = (-_C * _softplus(p["lru_a"])) * r  # (B, S, W)
    a = torch.exp(log_a)
    u = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xc)
    prev = cache["lru_state"] if cache is not None else None
    hseq = _lru_scan(a, u, prev)
    if cache is not None:
        cache["lru_state"].copy_(hseq[:, -1, :])
        cache["conv_state"].copy_(new_conv)
    out = layers.qdense((hseq * gate).to(rt.compute_dtype), p["proj_out"], rt, cb)
    x = x + out
    hm = layers.norm_apply(x, p["ln_mlp"], cfg.norm)
    return x + layers.mlp(hm, p["mlp"], cfg.act, rt, cb)


# ------------------------------------------- ring-buffer window attention
def window_cache_init(batch: int, cfg: ArchConfig, rt: Runtime, device="cpu") -> dict:
    """One attention block's ring: ``cache_init`` leaves of ``window`` slots
    and ``pos_buf`` (B, window) int32, −1 where a slot holds no token."""
    w = cfg.hybrid.window
    c = layers.cache_init(batch, w, cfg.n_kv_heads, cfg.head_dim, rt.cache_kind, rt.bcq_cfg,
                          device=device)
    c["pos_buf"] = torch.full((batch, w), -1, dtype=torch.int32, device=device)
    return c


def attn_block(x, p, cfg: ArchConfig, rt: Runtime, cb, positions, cache=None, cache_pos=None):
    """One local-attention block, in the reference's three branches:
    no cache (windowed self-attention); a cache and S > 1 (prefill: the
    windowed self-attention, then the last ``min(S, window)`` tokens' K/V
    projected again, encoded and written into their ring slots, ``pos_buf``
    set to match); a cache and S = 1 (decode: the token's K/V written at
    slot ``pos % window`` — per row when ``cache_pos`` is a (B,) vector —
    and attention over the ring masked by the stored absolute positions).
    The ring is written in place.  Returns the block's output."""
    h = layers.norm_apply(x, p["ln"], cfg.norm)
    w = cfg.hybrid.window
    hd = cfg.head_dim
    if cache is None:
        out, _ = layers.attention(h, p["attn"], cfg, rt, cb, positions, window=w)
    elif h.shape[1] > 1:
        b, s, _ = h.shape
        out, _ = layers.attention(h, p["attn"], cfg, rt, cb, positions, window=w)
        k, v = layers.qdense_shared(h, [p["attn"]["wk"], p["attn"]["wv"]], rt, cb)
        k = layers.rope(k.reshape(b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
        v = v.reshape(b, s, cfg.n_kv_heads, hd)
        n_keep = min(s, w)
        kept = torch.arange(s - n_keep, s, device=h.device)  # absolute positions kept
        slots = kept % w  # ring slot per kept token
        kv = {n: leaf for n, leaf in cache.items() if n != "pos_buf"}
        enc = layers.cache_encode(k[:, -n_keep:], v[:, -n_keep:], rt.cache_kind, rt.bcq_cfg,
                                  cb, kv)
        for n, val in enc.items():
            cache[n][:, slots] = val.to(cache[n].dtype)
        cache["pos_buf"].fill_(-1)
        cache["pos_buf"][:, slots] = kept.to(torch.int32)
    else:
        b, s, _ = h.shape
        q, k, v = layers.qdense_shared(
            h, [p["attn"]["wq"], p["attn"]["wk"], p["attn"]["wv"]], rt, cb)
        q = layers.rope(q.reshape(b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
        k = layers.rope(k.reshape(b, s, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
        v = v.reshape(b, s, cfg.n_kv_heads, hd)
        kv = {n: leaf for n, leaf in cache.items() if n != "pos_buf"}
        pos_buf = cache["pos_buf"]
        if isinstance(cache_pos, torch.Tensor) and cache_pos.ndim >= 1:
            # per-row decode (the state engine): each row its own ring slot
            slot_r = (cache_pos % w).long()
            layers.cache_write_rows(kv, k, v, slot_r, rt.cache_kind, rt.bcq_cfg, cb)
            pos_buf[torch.arange(b, device=h.device), slot_r] = positions[:, 0].to(torch.int32)
        else:
            slot = int(cache_pos) % w
            layers.cache_write(kv, k, v, slot, rt.cache_kind, rt.bcq_cfg, cb)
            start = max(0, min(slot, w - s))  # dynamic_update_slice's clamp
            pos_buf[:, start:start + s] = positions.to(torch.int32)
        kf, vf = layers.cache_read(kv, rt.cache_kind, rt.bcq_cfg, cb, rt.compute_dtype)
        # attend over the ring slots with the absolute-position mask
        rep = cfg.n_heads // cfg.n_kv_heads
        kx = torch.repeat_interleave(kf, rep, dim=2) if rep > 1 else kf
        vx = torch.repeat_interleave(vf, rep, dim=2) if rep > 1 else vf
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float())
        sc = sc * hd**-0.5
        pb = pos_buf[:, None, None, :]  # (B, 1, 1, window) absolute positions
        pq = positions[:, None, :, None]
        valid = (pb >= 0) & (pb <= pq) & (pq - pb < w)
        sc = torch.where(valid, sc, -1e30)
        att = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", att, vx.float()).to(rt.compute_dtype)
        out = layers.qdense(o.reshape(b, s, cfg.n_heads * hd), p["attn"]["wo"], rt, cb)
    x = x + out
    hm = layers.norm_apply(x, p["ln_mlp"], cfg.norm)
    return x + layers.mlp(hm, p["mlp"], cfg.act, rt, cb)


# ----------------------------------------------------------- full hybrid
def _counts(cfg: ArchConfig):
    """(period length, periods, tail blocks)."""
    period = len(cfg.hybrid.pattern)
    n_periods = cfg.n_layers // period
    return period, n_periods, cfg.n_layers - n_periods * period


def _rec_state(batch: int, w: int, device) -> dict:
    return {"lru_state": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv_state": torch.zeros((batch, 3, w), dtype=torch.float32, device=device)}


def hybrid_cache_init(cfg: ArchConfig, rt: Runtime, batch: int, device="cpu") -> dict:
    """The zero decode cache of ``batch`` rows, every leaf of ``periods``
    a real (P, ...) tensor (``device="meta"``: the shapes only)."""
    _, n_periods, tail = _counts(cfg)
    w = cfg.hybrid.lru_width or cfg.d_model
    one = {f"b{i}": (window_cache_init(batch, cfg, rt, device) if kind == "attn"
                     else _rec_state(batch, w, device))
           for i, kind in enumerate(cfg.hybrid.pattern)}
    periods = {b: {n: leaf[None].repeat((n_periods,) + (1,) * leaf.ndim)
                   for n, leaf in c.items()} for b, c in one.items()}
    return {"periods": periods, **{f"tail{t}": _rec_state(batch, w, device)
                                   for t in range(tail)}}


def hybrid_backbone(params, x, cfg: ArchConfig, rt: Runtime, positions, caches=None,
                    cache_pos=None):
    """The periods, then the tail blocks, then the final norm; with
    ``caches`` each block reads and writes its cache in place."""
    cb = params.get("codebooks")
    if cb is None and rt.quant_mode != "none":
        raise ValueError(f"quant_mode {rt.quant_mode!r} needs the tree's 'codebooks' (zoo.build's "
                         "init, or a quantize artifact); this tree has none")
    _, n_periods, tail = _counts(cfg)
    for pi in range(n_periods):
        pp = transformer._layer(params["periods"], pi)
        cp = None if caches is None else transformer._layer(caches["periods"], pi)
        for i, kind in enumerate(cfg.hybrid.pattern):
            cl = None if cp is None else cp[f"b{i}"]
            if kind == "attn":
                x = attn_block(x, pp[f"b{i}"], cfg, rt, cb, positions, cl, cache_pos)
            else:
                x = rec_block(x, pp[f"b{i}"], cfg, rt, cb, cl)
    for t in range(tail):
        cl = None if caches is None else caches[f"tail{t}"]
        x = rec_block(x, params[f"tail{t}"], cfg, rt, cb, cl)
    return layers.norm_apply(x, params["ln_f"], cfg.norm)


def _positions(b: int, s: int, device, start=0):
    return start + torch.arange(s, device=device)[None, :].expand(b, s)


def forward_train(params, batch, cfg: ArchConfig, rt: Runtime):
    """batch: {'tokens', 'labels' (B, S), optional 'mask'} → scalar loss."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = transformer.embed_tokens(params, tokens, rt)
    x = hybrid_backbone(params, x, cfg, rt, _positions(b, s, tokens.device))
    return transformer.xent_loss(params, x, batch["labels"], rt, batch.get("mask"))


def prefill(params, batch, cfg: ArchConfig, rt: Runtime, max_len=None):
    """The prompts (B, S) in parallel per block from zero states; the
    caches end with each block's final states and the ring holding the
    last ``window`` tokens (a 1-token prompt takes the decode branch).
    ``max_len`` is ignored (the cache is window-sized).  Returns
    (last-position logits (B, 1, V), caches)."""
    del max_len
    tokens = batch["tokens"]
    b, s = tokens.shape
    caches = hybrid_cache_init(cfg, rt, b, tokens.device)
    x = transformer.embed_tokens(params, tokens, rt)
    x = hybrid_backbone(params, x, cfg, rt, _positions(b, s, tokens.device), caches, cache_pos=0)
    return transformer.lm_logits(params, x[:, -1:, :], rt), caches


def decode_step(params, caches, tokens, pos, cfg: ArchConfig, rt: Runtime):
    """One step: tokens (B, 1) at ``pos``, an int (a homogeneous batch, the
    contiguous path) or a (B,) vector of per-row absolute positions (the
    state engine).  The caches are updated in place.  Returns (logits
    (B, 1, V), caches)."""
    b, s = tokens.shape
    x = transformer.embed_tokens(params, tokens, rt)
    if isinstance(pos, torch.Tensor) and pos.ndim >= 1:
        positions = pos.long()[:, None] + torch.arange(s, device=tokens.device)[None, :]
    else:
        positions = _positions(b, s, tokens.device, int(pos))
    x = hybrid_backbone(params, x, cfg, rt, positions, caches, cache_pos=pos)
    return transformer.lm_logits(params, x, rt), caches
