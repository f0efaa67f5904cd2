"""Mixture-of-Experts block (counterpart of ``repro/models/moe.py``): top-k
routing, capacity-bounded sort-based dispatch (no T×E×C one-hot tensors)
and the expert GEMMs, whose packed W4A4 form is one launch of the fused
linear's expert-stacked kernel per expert matrix (``kernels/ops.py``).

The router stays in f32 (not quantized, as the reference).  Nothing here
waits on the host — no ``nonzero``, boolean indexing or ``.item()`` — so a
CUDA graph captures the layer as it captures a dense one; the capacity is
a Python int of the static token count.  The combine sums each token's k
contributions in pair order with plain adds (no atomics), so a layer
gives the same bits on every run, which the decode graph and the depth-2
pipeline rely on.
"""
from __future__ import annotations

import torch

from repro_torch.core import bcq
from repro_torch.models import layers
from repro_torch.models.layers import Runtime


def init_moe(cfg, rt: Runtime, generator: torch.Generator, lead: tuple = ()) -> dict:
    """Random float parameters with the reference's shapes and scales: the
    router (d, E) in f32, the expert stacks ``wi``, ``wg`` (E, d, d_ff) and
    ``wo`` (E, d_ff, d), normal · 1/sqrt(d_in), drawn on ``generator``'s
    device with ``lead`` axes in front (a layer stack)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    dev = generator.device

    def normal(shape, scale, dtype):
        return (torch.randn(lead + shape, generator=generator, device=dev) * scale).to(dtype)

    return {
        "router": {"kernel": normal((d, e), d**-0.5, torch.float32)},
        "wi": {"kernel": normal((e, d, f), d**-0.5, rt.param_dtype)},
        "wg": {"kernel": normal((e, d, f), d**-0.5, rt.param_dtype)},
        "wo": {"kernel": normal((e, f, d), f**-0.5, rt.param_dtype)},
    }


def _expert_matmul(xe, wp, rt: Runtime, cb, tag=None):
    """xe: (E, C, K) tokens per expert; weight (E, K, N) → (E, C, N).
    ``tag`` names the site for the quant-error probe (its stats pool every
    expert's tokens, matching the shared per-tensor s_X)."""
    layers._emit_quant_probe(xe, rt, cb, tag)
    dt = rt.compute_dtype
    if rt.quant_mode == "none" or cb is None:
        return torch.einsum("eck,ekn->ecn", xe.to(dt), wp["kernel"].to(dt))
    if rt.quant_mode == "packed":
        if rt.fused_linear:
            # one s_X over ALL experts' rows, padding rows included, so the
            # activation quantization equals the unfused fake_quant(xe)
            s_x = bcq.tensor_scale(xe.float(), rt.bcq_cfg)
            return layers.fused_packed_experts(xe, wp["kernel_packed"], rt, cb, s_x).to(dt)
        xq = bcq.fake_quant(xe.float(), cb, rt.bcq_cfg).to(dt)
        w = layers.decode_packed_weight(wp["kernel_packed"], rt.bcq_cfg, cb).to(dt)
        return torch.einsum("eck,enk->ecn", xq, w)
    raise ValueError(f"quant_mode {rt.quant_mode!r} is not ported")


def moe_ffn(x, p, cfg, rt: Runtime, cb):
    """x: (B, S, D) → (out (B, S, D), aux_loss 0-d f32)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    xt = x.reshape(t, d)
    dev = x.device

    logits = xt.float() @ p["router"]["kernel"].float()  # (T, E), f32
    probs = torch.softmax(logits, dim=-1)
    # top-k with jax.lax.top_k's rule: on equal values the lower expert first
    srt, order_k = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_ids = srt[:, :k], order_k[:, :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch-style)
    top1 = expert_ids[:, :1] == torch.arange(e, device=dev)  # one-hot, no host check
    frac_tokens = top1.float().mean(0)
    frac_probs = probs.mean(0)
    aux = e * torch.sum(frac_tokens * frac_probs)

    cap = int(m.capacity_factor * t * k / e) + 1

    # rank of each (token, slot) pair within its expert via one stable sort
    flat_e = expert_ids.reshape(-1)  # (T·K,)
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    grp_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev), right=False)
    rank_sorted = torch.arange(tk, device=dev) - grp_start[sorted_e]
    rank = torch.zeros((tk,), dtype=torch.long, device=dev).scatter_(0, order, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap))  # overflow → trash column

    tok_of_pair = torch.arange(tk, device=dev) // k
    # (flat_e, slot) is unique off the trash column, whose writes are dropped
    table = torch.full((e, cap + 1), t, dtype=torch.long, device=dev)
    table[flat_e, slot] = tok_of_pair
    idx_ec = table[:, :cap]  # (E, C) token ids, t = the padding row

    xpad = torch.cat([xt, torch.zeros((1, d), dtype=xt.dtype, device=dev)], dim=0)
    xe = xpad[idx_ec]  # (E, C, D)

    h = _expert_matmul(xe, p["wi"], rt, cb, tag="moe_wi")
    g = _expert_matmul(xe, p["wg"], rt, cb, tag="moe_wg")
    h = torch.nn.functional.silu(g.float()).to(h.dtype) * h
    ye = _expert_matmul(h, p["wo"], rt, cb, tag="moe_wo")  # (E, C, D)

    # combine: each pair's output, weighted (a dropped pair reads a clipped
    # slot and is zeroed by ``keep``), summed per token in pair order
    contrib = ye[flat_e, torch.clamp_max(slot, cap - 1)]  # (T·K, D)
    w_pair = (gate.reshape(-1) * keep.float()).to(contrib.dtype)
    contrib = (contrib * w_pair[:, None]).reshape(t, k, d)
    out = torch.zeros((t, d), dtype=contrib.dtype, device=dev) + contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.reshape(b, s, d).to(x.dtype), aux
