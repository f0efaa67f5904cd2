"""Plain PyTorch oracles for the kernels (counterpart of ``repro/kernels/ref.py``).

Contracts (all 2-D, blocks along K):

``quantize_ref(x, codebooks, cfg, s_x)``
    x: (M, K) with K % L_A == 0.  Returns
      idx_packed: uint8 (M, K//2)          two 4-bit codeword indices / byte
      sel_packed: uint8 (M, K//L_b//2)     two 4-bit codebook selectors / byte
      ratio:      f32  (M, K//L_A)         E4M3-snapped ŝ_A = Q(s_A/s_X)

``matmul_ref(a..., w..., inv scales)``
    W4A4 GEMM: decode both operands, apply the per-array dequant scales,
    contract over K in f32:  out[m,n] = Σ_k Â[m,k]·Ŵ[n,k].
"""
from __future__ import annotations

import torch

from repro_torch.core import bcq
from repro_torch.core.bcq import BCQConfig, pack_nibbles, unpack_nibbles
from repro_torch.kernels.common import dequant_page


def quantize_ref(x: torch.Tensor, codebooks: torch.Tensor, cfg: BCQConfig, s_x):
    m, k = x.shape
    if k % cfg.array_len:
        raise ValueError("quantize_ref requires K % L_A == 0")
    arrays = x.float().reshape(m, k // cfg.array_len, cfg.array_len)
    ratio, scale = bcq._array_scales(arrays, cfg, s_x)
    blocks = (arrays * scale[..., None]).reshape(m, -1, cfg.block_len)
    sel, idx = bcq._select_and_index(blocks, codebooks)
    return pack_nibbles(idx.reshape(m, k)), pack_nibbles(sel.reshape(m, -1)), ratio


def decode_ref(idx_packed, sel_packed, inv_scale, codebooks, cfg: BCQConfig) -> torch.Tensor:
    """Dequantize a packed operand to f32 (M, K).  inv_scale = 1/(ŝ_A·s_X)."""
    idx = unpack_nibbles(idx_packed).long()
    k = idx.shape[-1]
    sel = unpack_nibbles(sel_packed).long()[..., : k // cfg.block_len]
    sel_s = torch.repeat_interleave(sel, cfg.block_len, dim=-1)
    vals = codebooks.reshape(-1)[sel_s * cfg.n_entries + idx]
    return vals * torch.repeat_interleave(inv_scale, cfg.array_len, dim=-1)


def matmul_ref(a_idx, a_sel, a_inv, w_idx, w_sel, w_inv, codebooks_a, codebooks_w,
               cfg: BCQConfig) -> torch.Tensor:
    """out (M, N) f32 = dequant(A) @ dequant(W)^T, K contraction."""
    a = decode_ref(a_idx, a_sel, a_inv, codebooks_a, cfg)
    w = decode_ref(w_idx, w_sel, w_inv, codebooks_w, cfg)
    return a @ w.T


def inv_scale(ratio: torch.Tensor, s_x) -> torch.Tensor:
    return 1.0 / (ratio * s_x)


def fused_linear_ref(x, w_idx, w_sel, w_inv, codebooks, cfg: BCQConfig, s_x,
                     valid_k: int | None = None) -> torch.Tensor:
    """Oracle for the fused W4A4 linear: encode x (M, Kp) on the fly,
    decode both operands, contract over K.  ``valid_k`` zeroes the
    activation dequant scale of padded-K arrays."""
    idx_p, sel_p, ratio = quantize_ref(x, codebooks, cfg, s_x)
    a_inv = inv_scale(ratio, s_x)
    if valid_k is not None:
        ka = x.shape[1] // cfg.array_len
        valid = (torch.arange(ka, device=x.device) * cfg.array_len) < valid_k
        a_inv = a_inv * valid[None, :]
    return matmul_ref(idx_p, sel_p, a_inv, w_idx, w_sel, w_inv, codebooks, codebooks, cfg)


def fused_linear_experts_ref(x, w_idx, w_sel, w_inv, codebooks, cfg: BCQConfig, s_x):
    """Oracle for the expert-stacked fused linear: ``fused_linear_ref`` of
    each expert's rows x[e] (C, K) against its weight (N, K), one shared
    ``s_x`` — the reference's per-expert loop (``moe.py:66-73``).
    Returns (E, C, N) f32."""
    return torch.stack([
        fused_linear_ref(x[e], w_idx[e], w_sel[e], w_inv[e], codebooks, cfg, s_x,
                         valid_k=x.shape[-1])
        for e in range(x.shape[0])
    ])


# ---------------------------------------------------- paged attention oracle
def _dequant_pool_ref(pool: dict, nm: str, kind: str, cfg: BCQConfig, cb) -> torch.Tensor:
    """Dequantize the whole page pool's K or V side to f32 (P, ps, H, D)."""
    if kind == "bf16":
        leaves = [pool[nm]]
    elif kind == "int8":
        leaves = [pool[nm], pool[f"{nm}_scale"]]
    elif kind == "bcq4":
        leaves = [pool[f"{nm}_idx"], pool[f"{nm}_sel"], pool[f"{nm}_scale"]]
    else:
        raise ValueError(kind)
    return dequant_page(kind, leaves, cfg, cb, pool.get(f"{nm}_sx"))


def _gather_softmax(q_bchd, pool, block_tables, qpos, kind, cfg, cb):
    """Exact masked softmax of q (B, C, H, D) over every gathered page
    token t <= qpos (B, C); masked scores are -1e30."""
    b, c, h, d = q_bchd.shape
    kf = _dequant_pool_ref(pool, "k", kind, cfg, cb)
    vf = _dequant_pool_ref(pool, "v", kind, cfg, cb)
    hkv = kf.shape[2]
    bt = block_tables.long()
    kg = kf[bt].reshape(b, -1, hkv, d)
    vg = vf[bt].reshape(b, -1, hkv, d)
    rep = h // hkv
    if rep > 1:
        kg = torch.repeat_interleave(kg, rep, dim=2)
        vg = torch.repeat_interleave(vg, rep, dim=2)
    s = torch.einsum("bchd,bthd->bhct", q_bchd.float(), kg) * d**-0.5
    tpos = torch.arange(kg.shape[1], device=q_bchd.device)
    mask = tpos[None, None, None, :] <= qpos[:, None, :, None]
    s = torch.where(mask, s, -1e30)
    return torch.einsum("bhct,bthd->bchd", torch.softmax(s, dim=-1), vg)


def paged_attention_ref(q, pool, block_tables, lengths, kind, cfg, cb=None):
    """Oracle for paged decode: q (B, H, D); lengths (B,) live tokens.
    Returns (B, H, D) f32."""
    qpos = (lengths.long() - 1)[:, None]
    return _gather_softmax(q[:, None], pool, block_tables, qpos, kind, cfg, cb)[:, 0]


def chunked_prefill_ref(q, pool, block_tables, n_past, kind, cfg, cb=None):
    """Oracle for chunked prefill: q (B, C, H, D), query c at absolute
    position n_past[b] + c.  Returns (B, C, H, D) f32."""
    c = q.shape[1]
    qpos = n_past.long()[:, None] + torch.arange(c, device=q.device)
    return _gather_softmax(q, pool, block_tables, qpos, kind, cfg, cb)
