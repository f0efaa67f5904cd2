"""Decoder-only transformer LM, dense and MoE families (counterpart of the
dense and MoE parts of ``repro/models/transformer.py``).

Parameters are the reference's tree: per-layer leaves stacked on a
leading layer axis (``params["layers"]``), the page pool likewise
(leaves (L, n_pages, page_size, ...)).  The layer loop is a Python loop
over views of both; page writes land in the pool in place.  Without a
pool the stack runs cache-free causal self-attention: the training /
evaluation forward (``forward_train``, scored by ``xent_loss``).  With
contiguous caches (``prefill`` / ``decode_step``) it is the slab path.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, moe as moe_lib
from repro_torch.models.layers import Runtime


# ------------------------------------------------------------------- init
def init_lm(cfg: ArchConfig, rt: Runtime, generator: torch.Generator) -> dict:
    """Random float parameters with the reference's shapes and scales
    (normal · 1/sqrt(d_in) for linears, 0.02 for the embedding; norms at
    scale 1, bias 0), drawn from ``generator`` (a dense model on the CPU;
    a MoE model on the generator's device: ``init_top``, then
    ``init_block`` of every layer, stacked)."""
    if cfg.family == "moe":
        params = init_top(cfg, rt, generator)
        blocks = [init_block(cfg, rt, generator) for _ in range(cfg.n_layers)]
        params["layers"] = stack_layers(blocks)
        return params
    L, d, hd, f = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    dt = rt.param_dtype

    def dense(d_in, d_out, scale=None):
        scale = scale if scale is not None else d_in**-0.5
        return (torch.randn((L, d_in, d_out), generator=generator) * scale).to(dt)

    def norm():
        return _norm(cfg, rt, (L,), "cpu")

    def lin(d_in, d_out, bias=False):
        p = {"kernel": dense(d_in, d_out)}
        if bias:
            p["bias"] = torch.zeros((L, d_out), dtype=dt)
        return p

    mlp = {"wi": lin(d, f), "wo": lin(f, d)}
    if cfg.act == "swiglu":
        mlp["wg"] = lin(d, f)
    params = {
        "embed": {"kernel": (torch.randn((cfg.vocab_padded, d), generator=generator) * 0.02).to(dt)},
        "layers": {
            "ln1": norm(),
            "attn": {
                "wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
                "wk": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wv": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wo": lin(cfg.n_heads * hd, d),
            },
            "ln2": norm(),
            "mlp": mlp,
        },
        "ln_f": {k: v[0] for k, v in norm().items()},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "kernel": (torch.randn((d, cfg.vocab_padded), generator=generator) * 0.02).to(dt)
        }
    return params


def init_top(cfg: ArchConfig, rt: Runtime, generator: torch.Generator) -> dict:
    """The parameters outside the layer stack — embedding, final norm and
    an untied ``lm_head`` — drawn on ``generator``'s device."""
    d, dt, dev = cfg.d_model, rt.param_dtype, generator.device
    params = {
        "embed": {"kernel": (torch.randn((cfg.vocab_padded, d), generator=generator,
                                         device=dev) * 0.02).to(dt)},
        "ln_f": _norm(cfg, rt, (), dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": (torch.randn((d, cfg.vocab_padded), generator=generator,
                                                    device=dev) * 0.02).to(dt)}
    return params


def init_block(cfg: ArchConfig, rt: Runtime, generator: torch.Generator) -> dict:
    """One MoE layer's parameters (no layer axis) on ``generator``'s
    device: attention, the two norms and ``moe`` (``moe.init_moe``)."""
    d, hd, dt, dev = cfg.d_model, cfg.head_dim, rt.param_dtype, generator.device

    def lin(d_in, d_out, bias=False):
        p = {"kernel": (torch.randn((d_in, d_out), generator=generator, device=dev)
                        * d_in**-0.5).to(dt)}
        if bias:
            p["bias"] = torch.zeros((d_out,), dtype=dt, device=dev)
        return p

    return {
        "ln1": _norm(cfg, rt, (), dev),
        "attn": {
            "wq": lin(d, cfg.n_heads * hd, cfg.qkv_bias),
            "wk": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            "wv": lin(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
            "wo": lin(cfg.n_heads * hd, d),
        },
        "ln2": _norm(cfg, rt, (), dev),
        "moe": moe_lib.init_moe(cfg, rt, generator),
    }


def _norm(cfg, rt: Runtime, lead: tuple, device) -> dict:
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=rt.param_dtype, device=device)}
    if cfg.norm == "layernorm":
        p["nbias"] = torch.zeros(lead + (cfg.d_model,), dtype=rt.param_dtype, device=device)
    return p


def stack_layers(blocks: list) -> dict:
    """Per-layer trees (equal structure) → one tree of (L, ...) leaves."""
    if isinstance(blocks[0], dict):
        return {k: stack_layers([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


# ----------------------------------------------------------- shared pieces
def embed_tokens(params, tokens, rt: Runtime):
    return params["embed"]["kernel"].to(rt.compute_dtype)[tokens.long()]


def lm_logits(params, x, rt: Runtime):
    if "lm_head" in params:
        w = params["lm_head"]["kernel"]
    else:
        w = params["embed"]["kernel"].T  # tied
    return x.to(rt.compute_dtype) @ w.to(rt.compute_dtype)


def xent_loss(params, x, labels, rt: Runtime, mask=None):
    """Mean next-token cross-entropy of final hidden states x (B, S, d)
    against labels (B, S), weighted by ``mask``.  With ``rt.logit_chunk``
    dividing S, the (B, S, V) logits are taken a chunk of positions at a
    time and never exist whole."""

    def piece(xc, lc, mc):
        logits = lm_logits(params, xc, rt).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        return ((lse - gold) * mc).sum(), mc.sum()

    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
    c, s = rt.logit_chunk, x.shape[1]
    if c and s > c and s % c == 0:
        parts = [piece(x[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c])
                 for i in range(0, s, c)]
        tot = torch.stack([t for t, _ in parts]).sum()
        cnt = torch.stack([n for _, n in parts]).sum()
    else:
        tot, cnt = piece(x, labels, mask)
    return tot / torch.clamp_min(cnt, 1.0)


def block_apply(x, p, cfg, rt: Runtime, cb, positions, paged, cache=None, cache_pos=None):
    """One layer: attention, then the MLP or, for the MoE family, the MoE
    block.  Returns (x, the layer's auxiliary loss: 0 unless MoE)."""
    h = layers.norm_apply(x, p["ln1"], cfg.norm)
    attn_out, _ = layers.attention(h, p["attn"], cfg, rt, cb, positions, paged, cache,
                                   cache_pos)
    x = x + attn_out
    h = layers.norm_apply(x, p["ln2"], cfg.norm)
    if cfg.family == "moe":
        f, aux = moe_lib.moe_ffn(h, p["moe"], cfg, rt, cb)
        return x + f, aux
    return x + layers.mlp(h, p["mlp"], cfg.act, rt, cb), None


def _layer(tree, i):
    """Layer i's view of a layer-stacked tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def backbone(params, x, cfg, rt: Runtime, positions, pool=None, paged_tables=None,
             caches=None, cache_pos=None):
    """Run the layer stack, over a page pool or contiguous caches when one
    is given.  ``paged_tables``: (block_tables, lengths) for decode, or
    (block_tables, n_past, chunk_page_ids[, chunk_len]) for chunked
    prefill (see layers.attention).  ``caches`` (layer-stacked, leaves
    (L, B, max_len, ...)) with ``cache_pos``: the slab path, caches
    written in place.  With neither: cache-free self-attention.  Returns
    (final hidden states, the layers' auxiliary loss summed in layer order
    as a 0-d f32 tensor — None for a dense model, which has none)."""
    cb = params.get("codebooks")
    if cb is None and rt.quant_mode != "none":
        raise ValueError(f"quant_mode {rt.quant_mode!r} needs the tree's 'codebooks' (zoo.build's "
                         "init, or a quantize artifact); this tree has none")
    aux = None
    for i in range(cfg.n_layers):
        paged = None if pool is None else (_layer(pool, i),) + tuple(paged_tables)
        cache = None if caches is None else _layer(caches, i)
        x, a = block_apply(x, _layer(params["layers"], i), cfg, rt, cb, positions, paged, cache,
                           cache_pos)
        if a is not None:
            aux = a if aux is None else aux + a
    return layers.norm_apply(x, params["ln_f"], cfg.norm), aux


def _forward(params, tokens, cfg: ArchConfig, rt: Runtime):
    b, s = tokens.shape
    x = embed_tokens(params, tokens, rt)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    return backbone(params, x, cfg, rt, positions)


def forward_hidden(params, tokens, cfg: ArchConfig, rt: Runtime):
    """Final hidden states (B, S, d) of the cache-free forward of tokens (B, S)."""
    return _forward(params, tokens, cfg, rt)[0]


def forward_train(params, batch, cfg: ArchConfig, rt: Runtime):
    """batch: {'tokens', 'labels' (B, S), optional 'mask'} → scalar loss,
    plus 0.01 × the MoE auxiliary loss for the MoE family (the
    reference's ``loss + 0.01 * aux``; a dense model has none)."""
    x, aux = _forward(params, batch["tokens"], cfg, rt)
    loss = xent_loss(params, x, batch["labels"], rt, batch.get("mask"))
    return loss if aux is None else loss + 0.01 * aux


def cache_init_stacked(cfg: ArchConfig, rt: Runtime, batch, max_len, device="cpu"):
    """Layer-stacked cache leaves; a page pool is (n_pages, page_size)."""
    one = layers.cache_init(batch, max_len, cfg.n_kv_heads, cfg.head_dim, rt.cache_kind,
                            rt.bcq_cfg, device=device)
    return {n: leaf[None].repeat((cfg.n_layers,) + (1,) * leaf.ndim) for n, leaf in one.items()}


def prefill(params, batch, cfg: ArchConfig, rt: Runtime, max_len: int):
    """Run the prompts (B, S) over fresh contiguous caches of ``max_len``
    positions.  Returns (last-position logits (B, 1, V), caches)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    caches = cache_init_stacked(cfg, rt, b, max_len, device=tokens.device)
    x = embed_tokens(params, tokens, rt)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x, _ = backbone(params, x, cfg, rt, positions, caches=caches, cache_pos=0)
    return lm_logits(params, x[:, -1:, :], rt), caches


def decode_step(params, caches, tokens, pos: int, cfg: ArchConfig, rt: Runtime):
    """One contiguous serving step: tokens (B, 1) at absolute position
    ``pos``; the caches hold ``pos`` valid entries and are updated in
    place.  Returns (logits (B, 1, V), caches)."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, rt)
    positions = pos + torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x, _ = backbone(params, x, cfg, rt, positions, caches=caches, cache_pos=pos)
    return lm_logits(params, x, rt), caches


def paged_decode_step(params, pool, tokens, block_tables, lengths, cfg: ArchConfig, rt: Runtime):
    """One paged serving step: tokens (B, 1) next token per sequence;
    block_tables (B, MAXP) int32; lengths (B,) tokens already in cache per
    sequence (the new token is written at that position).  Returns
    (logits (B, 1, V), pool) — the pool is updated in place."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, rt)
    positions = lengths[:, None].long() + torch.arange(s, device=tokens.device)[None, :]
    x, _ = backbone(params, x, cfg, rt, positions, pool, (block_tables, lengths))
    return lm_logits(params, x, rt), pool


def prefill_from_pages(params, tokens, pool, block_tables, n_past, chunk_page_ids,
                       cfg: ArchConfig, rt: Runtime, chunk_len=None):
    """Chunked prefill: run one prompt chunk per row against the page pool.

    tokens: (B, C) chunk of each prompt, starting at page-aligned
    ``n_past[b]``; chunk_page_ids: (B, ceil(C/ps)) private pages that
    receive the chunk's K/V; ``chunk_len`` (B,) valid tokens per row when C
    is a padded bucket.  Returns (logits (B, 1, V) at each row's last
    valid position, pool) — the pool is updated in place."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, rt)
    positions = n_past[:, None].long() + torch.arange(s, device=tokens.device)[None, :]
    paged_tables = (block_tables, n_past, chunk_page_ids)
    if chunk_len is not None:
        paged_tables += (chunk_len,)
    x, _ = backbone(params, x, cfg, rt, positions, pool, paged_tables)
    if chunk_len is None:
        x_last = x[:, -1:, :]
    else:
        last = (chunk_len.long() - 1).clamp(0, s - 1)
        x_last = x[torch.arange(b, device=x.device), last][:, None, :]
    return lm_logits(params, x_last, rt), pool
