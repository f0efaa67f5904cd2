"""Mamba-2 SSD (state-space duality, arXiv:2405.21060) language model
(counterpart of ``repro/models/ssm.py``).

Chunked train/prefill path: the intra-chunk "attention-like" term plus
the inter-chunk linear recurrence, here a sequential loop over the
chunks (the reference runs it as an associative scan: the same sums in
another f32 order).  O(1)-state decode path for serving.  The in/out
projections are GEMMs and follow ``rt.quant_mode`` (``packed``: the fused
W4A4 linear, B1 on the card); the recurrence has no weight GEMM, so it
stays in f32 plain PyTorch, as the reference keeps it in plain ``jnp``.

Parameters are the reference's tree, per-layer leaves stacked on a
leading layer axis.  The decode cache (``ssm_cache_stacked``): leaves
``ssm_state`` (L, B, H, P, N) and ``conv_state`` (L, B, d_conv−1, C),
f32; ``decode_step`` writes them in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, transformer
from repro_torch.models.layers import Runtime


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L) → (..., L, L) lower-triangular cumulative sums
    Σ_{j<i≤k} x_i; −inf above the diagonal, so ``exp`` gives exact zeros."""
    n = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    d = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, torch.full_like(d, -torch.inf))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|))
    (``F.softplus`` returns x itself above its threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _dims(cfg: ArchConfig):
    """(d_inner, heads, conv channels, in_proj width)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    h = di // s.head_dim
    conv_ch = di + 2 * s.d_state  # x, B, C share the causal conv (g=1)
    return di, h, conv_ch, 2 * di + 2 * s.d_state + h


def init_ssm_lm(cfg: ArchConfig, rt: Runtime, generator: torch.Generator) -> dict:
    """Random float parameters with the reference's shapes and scales,
    drawn on the CPU from ``generator``: linears normal · 1/sqrt(d_in), the
    depthwise conv normal · 0.5, the embedding 0.02; ``A_log = log(1..h)``,
    ``D = 1``, ``dt_bias = 0`` and the norms at scale 1, as the reference
    sets them."""
    L, d, dt = cfg.n_layers, cfg.d_model, rt.param_dtype
    di, h, conv_ch, n_in = _dims(cfg)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(dt)

    params = {"embed": {"kernel": normal((cfg.vocab_padded, d), 0.02)}}
    mixer = {
        "in_proj": {"kernel": normal((L, d, n_in), d**-0.5)},
        "conv_kernel": normal((L, cfg.ssm.d_conv, conv_ch), 0.5),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32)).repeat(L, 1),
        "D": torch.ones((L, h), dtype=torch.float32),
        "dt_bias": torch.zeros((L, h), dtype=torch.float32),
        "out_proj": {"kernel": normal((L, di, d), di**-0.5)},
        "gnorm": {"scale": torch.ones((L, di), dtype=dt)},
    }
    params["layers"] = {"ln": {"scale": torch.ones((L, d), dtype=dt)}, "mixer": mixer}
    params["ln_f"] = {"scale": torch.ones((d,), dtype=dt)}
    return params


def _causal_conv(xbc, kernel, state=None):
    """Depthwise causal conv of window K, the taps summed left to right from
    tap 0.  xbc (B, S, C); state (B, K−1, C) history or None (zeros).
    Returns (silu(out) f32, the new state: the last K−1 rows)."""
    k = kernel.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[-1]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # (B, S+K-1, C)
    s = xbc.shape[1]
    out = xp[:, 0:s, :] * kernel[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * kernel[i][None, None, :]
    return torch.nn.functional.silu(out.float()), xp[:, xp.shape[1] - (k - 1):, :]


def ssd_chunked(x, dt, a, b_in, c_in, chunk: int):
    """The SSD scan.  x (B, S, H, P) with dt folded in; dt (B, S, H); a (H,)
    negative; b_in / c_in (B, S, N).  Returns (y (B, S, H, P), final state
    (B, H, P, N))."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_in.reshape(bsz, nc, chunk, n)
    cc = c_in.reshape(bsz, nc, chunk, n)

    da_t = (dtc * a[None, None, None, :]).transpose(2, 3)  # (B, nc, H, Q)
    da_cum = torch.cumsum(da_t, dim=-1)

    # 1. intra-chunk (quadratic within the chunk)
    l_mat = torch.exp(_segsum(da_t))  # (B, nc, H, Q, Q)
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y_diag = torch.einsum("bcls,bchls,bcshp->bclhp", scores, l_mat, xc)

    # 2. per-chunk end states
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)  # (B, nc, H, Q)
    states = torch.einsum("bcln,bchl,bclhp->bchpn", bc, decay_states, xc)

    # 3. inter-chunk recurrence S_c = exp(Σda_c)·S_{c-1} + states_c, in order
    chunk_decay = torch.exp(da_cum[..., -1])  # (B, nc, H)
    run = states[:, 0]
    prev = [torch.zeros_like(run)]  # the state entering each chunk
    for c in range(1, nc):
        prev.append(run)
        run = states[:, c] + chunk_decay[:, c, :, None, None] * run
    prev = torch.stack(prev, dim=1)

    # 4. inter-chunk contribution
    state_decay = torch.exp(da_cum)  # (B, nc, H, Q)
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", cc, prev, state_decay)
    return (y_diag + y_off).reshape(bsz, s, h, p), run


def _chunk_of(s_cfg, s: int) -> int:
    """The reference's chunk: min(chunk, S), halved until it divides S."""
    chunk = min(s_cfg.chunk, s)
    while s % chunk:
        chunk //= 2
    return chunk


def ssm_block(x, p, cfg: ArchConfig, rt: Runtime, cb, cache=None):
    """x (B, S, D).  ``cache`` {'ssm_state', 'conv_state'} for decode (the
    recurrent step over S, S = 1 in serving) or None for train/prefill
    (the chunked scan).  Returns (y, the new cache: the final states)."""
    s_cfg = cfg.ssm
    bsz, s, _ = x.shape
    di, h, _, _ = _dims(cfg)
    zxbcdt = layers.qdense(x, p["in_proj"], rt, cb)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * s_cfg.d_state, h], dim=-1)
    conv_state = cache["conv_state"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_kernel"].float(), conv_state)
    xs, b_in, c_in = torch.split(xbc, [di, s_cfg.d_state, s_cfg.d_state], dim=-1)
    dt = _softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H)
    a = -torch.exp(p["A_log"])  # (H,)
    xh = xs.reshape(bsz, s, h, s_cfg.head_dim).float()
    xdt = xh * dt[..., None]

    if cache is None:
        y, state = ssd_chunked(xdt, dt, a, b_in.float(), c_in.float(), _chunk_of(s_cfg, s))
    else:
        state = cache["ssm_state"]  # (B, H, P, N)
        b_f, c_f = b_in.float(), c_in.float()
        ys = []
        for t in range(s):
            decay = torch.exp(dt[:, t] * a[None, :])  # (B, H)
            state = state * decay[..., None, None] + torch.einsum(
                "bhp,bn->bhpn", xdt[:, t], b_f[:, t])
            ys.append(torch.einsum("bhpn,bn->bhp", state, c_f[:, t]))
        y = torch.stack(ys, dim=1)

    y = y + xh * p["D"][None, None, :, None]  # skip connection
    y = y.reshape(bsz, s, di)
    y = y * torch.nn.functional.silu(z.float())  # gate
    y = layers.norm_apply(y.to(rt.compute_dtype), p["gnorm"], "rmsnorm")
    return layers.qdense(y, p["out_proj"], rt, cb), {"ssm_state": state, "conv_state": new_conv}


def ssm_cache_init(batch: int, cfg: ArchConfig, device="cpu") -> dict:
    """One layer's zero decode cache for ``batch`` rows (``device="meta"``
    allocates nothing: the shapes only)."""
    s = cfg.ssm
    di, h, conv_ch, _ = _dims(cfg)
    return {
        "ssm_state": torch.zeros((batch, h, s.head_dim, s.d_state), dtype=torch.float32,
                                 device=device),
        "conv_state": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=torch.float32,
                                  device=device),
    }


def ssm_cache_stacked(cfg: ArchConfig, batch: int, device="cpu") -> dict:
    """The layer-stacked zero cache, leaves (L, batch, ...)."""
    return {n: leaf[None].repeat((cfg.n_layers,) + (1,) * leaf.ndim)
            for n, leaf in ssm_cache_init(batch, cfg, device).items()}


def _ssm_layer(x, p, cfg: ArchConfig, rt: Runtime, cb, cache):
    """One layer's mixer output on x and its new states (not yet stored)."""
    return ssm_block(layers.norm_apply(x, p["ln"], "rmsnorm"), p["mixer"], cfg, rt, cb, cache)


def ssm_backbone(params, x, cfg: ArchConfig, rt: Runtime, caches=None, out_caches=None):
    """The layer stack.  ``caches`` (layer-stacked): the recurrent decode,
    each layer's new states written into them in place.  ``out_caches``
    without ``caches``: the chunked scan, each layer's final states
    written there (prefill).  Returns the final hidden states."""
    cb = params.get("codebooks")
    if cb is None and rt.quant_mode != "none":
        raise ValueError(f"quant_mode {rt.quant_mode!r} needs the tree's 'codebooks' (zoo.build's "
                         "init, or a quantize artifact); this tree has none")
    layer = layers.maybe_remat(_ssm_layer, rt)
    for i in range(cfg.n_layers):
        p = transformer._layer(params["layers"], i)
        cache = None if caches is None else transformer._layer(caches, i)
        out, new = layer(x, p, cfg, rt, cb, cache)
        dst = cache if cache is not None else (
            None if out_caches is None else transformer._layer(out_caches, i))
        if dst is not None:
            for n, leaf in new.items():
                dst[n].copy_(leaf)
        x = x + out
    return layers.norm_apply(x, params["ln_f"], "rmsnorm")


def forward_train(params, batch, cfg: ArchConfig, rt: Runtime):
    """batch: {'tokens', 'labels' (B, S), optional 'mask'} → scalar loss."""
    x = transformer.embed_tokens(params, batch["tokens"], rt)
    x = ssm_backbone(params, x, cfg, rt)
    return transformer.xent_loss(params, x, batch["labels"], rt, batch.get("mask"))


def prefill(params, batch, cfg: ArchConfig, rt: Runtime, max_len=None):
    """The chunked scan over the prompts (B, S); the caches are each layer's
    final states.  ``max_len`` is ignored (the state is O(1)).  Returns
    (last-position logits (B, 1, V), caches)."""
    del max_len
    tokens = batch["tokens"]
    caches = ssm_cache_stacked(cfg, tokens.shape[0], tokens.device)
    x = transformer.embed_tokens(params, tokens, rt)
    x = ssm_backbone(params, x, cfg, rt, out_caches=caches)
    return transformer.lm_logits(params, x[:, -1:, :], rt), caches


def decode_step(params, caches, tokens, pos, cfg: ArchConfig, rt: Runtime):
    """One recurrent step: tokens (B, 1); ``pos`` (an int or a (B,) vector)
    is ignored, the state being position-free.  The caches are updated in
    place.  Returns (logits (B, 1, V), caches)."""
    del pos
    x = transformer.embed_tokens(params, tokens, rt)
    x = ssm_backbone(params, x, cfg, rt, caches)
    return transformer.lm_logits(params, x, rt), caches
