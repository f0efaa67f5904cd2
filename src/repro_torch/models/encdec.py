"""Whisper-style encoder-decoder (arXiv:2212.04356); the counterpart of
``repro/models/encdec.py``.

The conv audio frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, T_enc, D).  The encoder is a
bidirectional self-attention stack over the frames plus sinusoidal
positions; the decoder is causal self-attention, cross-attention to the
encoder's per-layer K/V and an MLP, with a contiguous KV cache for
serving.  Every GEMM, the cross-attention projections included, follows
``rt.quant_mode`` (``packed``: the fused W4A4 linear, B1 on the card);
the decoder's cache-free self-attention (the evaluation forward) takes
the flash kernel with ``rt.flash_kernel``.  The sinusoidal positions, the
encoder's bidirectional attention, the cross-attention and the gather
from the encoder pool stay plain PyTorch, as the reference keeps them in
plain ``jnp``.

Parameters are the reference's tree: ``enc_layers`` and ``dec_layers``
with a leading layer axis (a decoder block adds ``ln_x`` and ``xattn``),
``ln_enc``, ``ln_f`` and the tied ``embed``.  The layer loops are Python
loops over views of the stacks; caches are written in place.

The serving half (``encode_xkv``, ``enc_pool_init``, ``enc_store``,
``prefill_with_xkv``, ``decode_step_shared``): the encoder output depends
only on the audio, so ``StatePagedEngine`` encodes once per distinct
input, publishes the per-layer cross K/V into a read-only ``shared_ro``
page of the encoder pool, and every request over the same audio
cross-attends to that page.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, transformer
from repro_torch.models.hybrid import _dense, _mlp
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import _layer


def _sinusoidal(length: int, d: int, device="cpu") -> torch.Tensor:
    """(length, d) f32: sin of pos / 10000^(2i/d) for the first d/2
    columns, cos for the rest."""
    pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal embedding at (B, S) positions: (B, S, d) f32."""
    i = torch.arange(d // 2, device=positions.device, dtype=torch.float32)[None, None, :]
    ang = positions[..., None].float() / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ------------------------------------------------------------------- init
def _attn(g: torch.Generator, cfg: ArchConfig, rt: Runtime) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {"wq": _dense(g, d, cfg.n_heads * hd, rt, cfg.qkv_bias),
            "wk": _dense(g, d, cfg.n_kv_heads * hd, rt, cfg.qkv_bias),
            "wv": _dense(g, d, cfg.n_kv_heads * hd, rt, cfg.qkv_bias),
            "wo": _dense(g, cfg.n_heads * hd, d, rt)}


def init_enc_block(cfg: ArchConfig, rt: Runtime, g: torch.Generator) -> dict:
    """One encoder block's float parameters (no layer axis) with the
    reference's shapes and scales: linears normal · 1/sqrt(d_in), norms at
    scale 1 and bias 0."""
    dev = g.device
    return {"ln1": transformer._norm(cfg, rt, (), dev), "attn": _attn(g, cfg, rt),
            "ln2": transformer._norm(cfg, rt, (), dev), "mlp": _mlp(g, cfg, rt)}


def init_dec_block(cfg: ArchConfig, rt: Runtime, g: torch.Generator) -> dict:
    """One decoder block: an encoder block's parameters, the cross
    attention's norm ``ln_x`` and projections ``xattn``."""
    p = init_enc_block(cfg, rt, g)
    p["ln_x"] = transformer._norm(cfg, rt, (), g.device)
    p["xattn"] = _attn(g, cfg, rt)
    return p


def init_encdec(cfg: ArchConfig, rt: Runtime, g: torch.Generator) -> dict:
    """Random float parameters of the whole model drawn from ``g``: the
    embedding (and an untied ``lm_head``), the encoder blocks, the decoder
    blocks (each stack (L, ...)), ``ln_enc`` and ``ln_f``."""
    params = transformer.init_top(cfg, rt, g)
    params["enc_layers"] = transformer.stack_layers(
        [init_enc_block(cfg, rt, g) for _ in range(cfg.n_encoder_layers)])
    params["dec_layers"] = transformer.stack_layers(
        [init_dec_block(cfg, rt, g) for _ in range(cfg.n_layers)])
    params["ln_enc"] = transformer._norm(cfg, rt, (), g.device)
    return params


# ---------------------------------------------------------------- forward
def _codebooks(params, rt: Runtime):
    cb = params.get("codebooks")
    if cb is None and rt.quant_mode != "none":
        raise ValueError(f"quant_mode {rt.quant_mode!r} needs the tree's 'codebooks' (zoo.build's "
                         "init, or a quantize artifact); this tree has none")
    return cb


def encode(params, frames, cfg: ArchConfig, rt: Runtime):
    """frames: (B, T_enc, D) stub embeddings → encoder states (B, T_enc, D)."""
    cb = _codebooks(params, rt)
    b, t, d = frames.shape
    x = frames.to(rt.compute_dtype) + _sinusoidal(t, d, frames.device)[None].to(rt.compute_dtype)
    positions = torch.arange(t, device=frames.device)[None, :].expand(b, t)
    block = layers.maybe_remat(_enc_block, rt)
    for i in range(cfg.n_encoder_layers):
        x = block(x, _layer(params["enc_layers"], i), cfg, rt, cb, positions)
    return layers.norm_apply(x, params["ln_enc"], cfg.norm)


def _enc_block(x, p, cfg, rt: Runtime, cb, positions):
    """One encoder block: bidirectional self-attention, the MLP."""
    h = layers.norm_apply(x, p["ln1"], cfg.norm)
    a, _ = layers.attention(h, p["attn"], cfg, rt, cb, positions, causal=False, use_rope=False)
    x = x + a
    h = layers.norm_apply(x, p["ln2"], cfg.norm)
    return x + layers.mlp(h, p["mlp"], cfg.act, rt, cb)


def _dec_block(h, p, cfg, rt: Runtime, cb, positions, enc_kv, cache=None, cache_pos=None):
    """One decoder block: causal self-attention (over ``cache`` when given),
    cross-attention to ``enc_kv`` = (k, v) (B, T_enc, Hkv, D), the MLP."""
    hh = layers.norm_apply(h, p["ln1"], cfg.norm)
    a, _ = layers.attention(hh, p["attn"], cfg, rt, cb, positions, cache=cache,
                            cache_pos=cache_pos, use_rope=False)
    h = h + a
    hh = layers.norm_apply(h, p["ln_x"], cfg.norm)
    xa, _ = layers.attention(hh, p["xattn"], cfg, rt, cb, positions, causal=False,
                             kv_override=enc_kv, use_rope=False)
    h = h + xa
    hh = layers.norm_apply(h, p["ln2"], cfg.norm)
    return h + layers.mlp(hh, p["mlp"], cfg.act, rt, cb)


def _cross_kv(params, enc_out, cfg: ArchConfig, rt: Runtime, cb):
    """Every decoder layer's cross K/V of the encoder output: (xk, xv), each
    (L, B, T_enc, Hkv, hd)."""
    b, t, _ = enc_out.shape
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer(params["dec_layers"], i)["xattn"]
        k, v = layers.qdense_shared(enc_out, [p["wk"], p["wv"]], rt, cb)
        ks.append(k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim))
        vs.append(v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim))
    return torch.stack(ks), torch.stack(vs)


def decoder(params, tokens, enc_out, cfg: ArchConfig, rt: Runtime, positions, caches=None,
            cache_pos=None, xkv=None):
    """The decoder stack over tokens (B, S) at ``positions`` (B, S):
    cross-attending to ``xkv`` (indexable by layer: layer i's (k, v) is
    ``(xkv[0][i], xkv[1][i])``), or to the cross K/V of ``enc_out``.  With
    ``caches`` (layer-stacked) and ``cache_pos`` the self-attention writes
    them in place.  Returns (final hidden states, caches)."""
    cb = _codebooks(params, rt)
    x = transformer.embed_tokens(params, tokens, rt)
    x = x + _sinusoidal_at(positions, cfg.d_model).to(x.dtype)
    if xkv is None:
        xkv = _cross_kv(params, enc_out, cfg, rt, cb)
    block = layers.maybe_remat(_dec_block, rt)
    for i in range(cfg.n_layers):
        cache = None if caches is None else _layer(caches, i)
        x = block(x, _layer(params["dec_layers"], i), cfg, rt, cb, positions,
                  (xkv[0][i], xkv[1][i]), cache, cache_pos)
    return layers.norm_apply(x, params["ln_f"], cfg.norm), caches


def _positions(tokens, start):
    """(B, S) absolute positions from ``start``: an int, or a (B,) tensor of
    each row's own."""
    b, s = tokens.shape
    steps = torch.arange(s, device=tokens.device)[None, :]
    if torch.is_tensor(start) and start.ndim >= 1:
        return start.long()[:, None] + steps
    return (start + steps).expand(b, s)


def forward_train(params, batch, cfg: ArchConfig, rt: Runtime):
    """batch: {'frames' (B, T, D), 'tokens', 'labels' (B, S), optional
    'mask'} → the mean next-token cross-entropy."""
    enc_out = encode(params, batch["frames"], cfg, rt)
    x, _ = decoder(params, batch["tokens"], enc_out, cfg, rt, _positions(batch["tokens"], 0))
    return transformer.xent_loss(params, x, batch["labels"], rt, batch.get("mask"))


def prefill(params, batch, cfg: ArchConfig, rt: Runtime, max_len: int):
    """Encode the frames and run the prompts (B, S) over fresh contiguous
    self caches of ``max_len`` positions.  Returns (last-position logits
    (B, 1, V), {'self': caches, 'xkv': the cross K/V})."""
    tokens = batch["tokens"]
    enc_out = encode(params, batch["frames"], cfg, rt)
    xkv = _cross_kv(params, enc_out, cfg, rt, _codebooks(params, rt))
    caches = transformer.cache_init_stacked(cfg, rt, tokens.shape[0], max_len,
                                            device=tokens.device)
    x, caches = decoder(params, tokens, None, cfg, rt, _positions(tokens, 0), caches,
                        cache_pos=0, xkv=xkv)
    return transformer.lm_logits(params, x[:, -1:, :], rt), {"self": caches, "xkv": xkv}


def decode_step(params, caches, tokens, pos, cfg: ArchConfig, rt: Runtime):
    """One serving step: tokens (B, 1) at ``pos``, an int or a (B,) tensor
    of per-row positions (the state engine's live tree); the self caches
    are written in place.  Returns (logits (B, 1, V), caches)."""
    x, _ = decoder(params, tokens, None, cfg, rt, _positions(tokens, pos), caches["self"],
                   cache_pos=pos, xkv=caches["xkv"])
    return transformer.lm_logits(params, x, rt), caches


# ------------------------------------------- shared encoder-output serving
def encode_xkv(params, frames, cfg: ArchConfig, rt: Runtime):
    """The encoder and the cross K/V projections: a shared_ro page's
    payload.  frames (B, T_enc, D) → (xk, xv), each (L, B, T_enc, Hkv, hd)."""
    return _cross_kv(params, encode(params, frames, cfg, rt), cfg, rt, _codebooks(params, rt))


def enc_pool_init(n_pages: int, cfg: ArchConfig, rt: Runtime, device="cpu"):
    """The pool of shared_ro encoder pages: (xk, xv), each (n_pages, L,
    T_enc, Hkv, hd) in the compute dtype; the page id indexes axis 0.
    Page 0, the null page, stays zero: idle rows read it."""
    shape = (n_pages, cfg.n_layers, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
    return tuple(torch.zeros(shape, dtype=rt.compute_dtype, device=device) for _ in range(2))


def enc_store(pool, xkv, pid):
    """Publish a batch-1 encode's cross K/V (each (L, 1, T, H, d)) into page
    ``pid`` of the pool, in place.  Returns the pool."""
    for leaf, val in zip(pool, xkv):
        leaf[pid] = val[:, 0].to(leaf.dtype)
    return pool


def prefill_with_xkv(params, batch, cfg: ArchConfig, rt: Runtime, max_len: int, xkv):
    """The decoder-only prefill against precomputed cross K/V (a shared-page
    hit): ``prefill`` less the encoder.  Returns (last-position logits,
    self caches)."""
    tokens = batch["tokens"]
    caches = transformer.cache_init_stacked(cfg, rt, tokens.shape[0], max_len,
                                            device=tokens.device)
    x, caches = decoder(params, tokens, None, cfg, rt, _positions(tokens, 0), caches,
                        cache_pos=0, xkv=xkv)
    return transformer.lm_logits(params, x[:, -1:, :], rt), caches


class _PageLayers:
    """The rows' encoder pages one layer at a time: item i is
    ``pool[pids, i]`` (B, T_enc, Hkv, hd), the reference's
    ``moveaxis(pool[pids], 0, 1)[i]`` without gathering every layer at once."""

    def __init__(self, pool: torch.Tensor, pids: torch.Tensor):
        self.pool, self.pids = pool, pids.long()

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.pool[self.pids, i]


def decode_step_shared(params, live, tokens, pos, enc_pool, enc_pids, cfg: ArchConfig,
                       rt: Runtime):
    """The per-row decode against shared encoder pages: live {'self': the
    decoder self caches of B rows}, ``enc_pids`` (B,) each row's page of
    ``enc_pool`` (the null page for an idle row).  The gather reads the
    encoder K/V that cross-attention reads anyway: sharing the page saves
    the encoder's compute and storage, not the tick's read.  Returns
    (logits (B, 1, V), live), written in place."""
    xkv = (_PageLayers(enc_pool[0], enc_pids), _PageLayers(enc_pool[1], enc_pids))
    logits, _ = decode_step(params, {"self": live["self"], "xkv": xkv}, tokens, pos, cfg, rt)
    return logits, live
