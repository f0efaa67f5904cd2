"""Wrappers around the W4A4 kernels (counterpart of ``repro/kernels/ops.py``).

Two routes to the same linear:

* ``w4a4_linear_fused`` — one call (``kernels/bcq_linear.py``) that
  encodes the raw activation to int8 codewords once and multiplies them
  (two device kernels behind one C entry); ``w4a4_linear_fused_experts``
  is its expert-stacked form, the E linears of a mixture-of-experts layer
  in one call;
* ``w4a4_linear`` — two calls, ``quantize`` (``kernels/bcq_quantize.py``)
  then ``matmul`` (``kernels/bcq_matmul.py``), the packed activation
  round-tripping through device memory.  Both routes share the encode
  and the int8 tensor-core GEMM, and give the same bits.  The model never takes this
  route (the reference's ``Runtime(fused_linear=False)`` decodes and
  multiplies in plain code instead); it is the kernel API of
  ``examples/quickstart.py`` and ``benchmarks/kernel_bench.py``.

The dispatch is by device: CUDA tensors launch the kernels, CPU tensors
run their plain versions.  The wrappers own the per-tensor activation
scale: ``s_x`` is one torch reduction over the whole launch batch
(``ops.py:187-190``), so every row of a launch shares it — the reason the
serving engine stages launches exactly like the reference.  The kernels
mask ragged M and N; K must be a multiple of L_A, and the GEMM wrappers
pad it to whole 64-wide steps with zero arrays where it is not one of 64
(``bcq_linear.pad_weight``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bcq, formats
from repro_torch.core.bcq import BCQConfig
from repro_torch.kernels.bcq_linear import bcq_linear, bcq_linear_experts
from repro_torch.kernels.bcq_matmul import bcq_matmul
from repro_torch.kernels.bcq_quantize import bcq_quantize


@dataclasses.dataclass
class PackedOperand:
    idx_packed: torch.Tensor  # uint8 (R, K//2)
    sel_packed: torch.Tensor  # uint8 (R, K//(2·L_b))
    inv_scale: torch.Tensor  # f32  (R, K//L_A) = 1/(ŝ_A·s_X)
    k: int  # reduction length


def decode_inv_scale(pk: dict) -> torch.Tensor:
    """The dequant scales 1/(ŝ_A·s_W) of a packed (..., N, K) weight from
    its E4M3 scale bits (zero where never written); a stack's ``s_x`` has
    its leading shape (one per layer or expert)."""
    ratio = formats.bits_to_e4m3(pk["scale"])
    s_x = pk["s_x"]
    s_x = s_x.reshape(s_x.shape + (1,) * (ratio.ndim - s_x.ndim))
    return torch.where(ratio > 0, 1.0 / (ratio * s_x), torch.zeros_like(ratio))


def packed_operand(pk: dict) -> PackedOperand:
    """View a packed weight dict (``layers.pack_weight`` layout: idx / sel /
    E4M3 scale bits / s_x) as a PackedOperand: one (N, K) weight, or an
    expert stack (E, N, K).  Its dequant scales are the ``inv_scale`` the
    tree carries where they were decoded once (``ptq.decode_scales``),
    else decoded here (``decode_inv_scale``)."""
    if pk["idx"].ndim not in (2, 3):
        raise ValueError("packed_operand takes one (N, K) weight or one (E, N, K) stack")
    inv = pk.get("inv_scale")
    if inv is None:
        inv = decode_inv_scale(pk)
    return PackedOperand(pk["idx"], pk["sel"], inv, pk["idx"].shape[-1] * 2)


def quantize(x: torch.Tensor, codebooks: torch.Tensor, cfg: BCQConfig,
             s_x: torch.Tensor | None = None) -> PackedOperand:
    """Encode a 2-D operand (rows × reduction K, K % L_A == 0) to packed
    LO-BCQ; ``s_x`` defaults to the per-tensor reduction over x."""
    k = x.shape[1]
    if k % cfg.array_len:
        raise ValueError(f"quantize: K={k} is not a multiple of L_A={cfg.array_len}")
    xf = x.float().contiguous()
    if s_x is None:
        s_x = bcq.tensor_scale(xf, cfg)
    idx_p, sel_p, ratio = bcq_quantize(xf, codebooks, s_x, cfg)
    inv = torch.ones_like(ratio) / (ratio * s_x)  # tensor / tensor, as XLA divides
    return PackedOperand(idx_p, sel_p, inv, k)


def matmul(a: PackedOperand, w: PackedOperand, codebooks: torch.Tensor,
           cfg: BCQConfig) -> torch.Tensor:
    """W4A4 GEMM: (M, K)·(N, K)ᵀ on packed operands → f32 (M, N)."""
    if a.k != w.k:
        raise ValueError(f"matmul: K={a.k} vs weight K={w.k}")
    return bcq_matmul(a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed, w.sel_packed,
                      w.inv_scale, codebooks, codebooks, cfg)


def w4a4_linear(x: torch.Tensor, w: PackedOperand, codebooks: torch.Tensor,
                cfg: BCQConfig) -> torch.Tensor:
    """Two-launch W4A4 linear: ``quantize`` the activation (dynamic s_X),
    then ``matmul`` with the pre-encoded weight (N, K).  x: (..., K).
    Returns (..., N) in x.dtype."""
    lead = x.shape[:-1]
    a = quantize(x.reshape(-1, x.shape[-1]), codebooks, cfg)
    return matmul(a, w, codebooks, cfg).reshape(*lead, -1).to(x.dtype)


def w4a4_linear_fused(x: torch.Tensor, w: PackedOperand, codebooks: torch.Tensor,
                      cfg: BCQConfig, s_x: torch.Tensor | None = None) -> torch.Tensor:
    """Fused W4A4 linear (one kernel call).  x: (..., K); weights pre-encoded
    (N, K); ``s_x`` overrides the per-tensor activation scale (default: the
    reduction over all of x).  Returns (..., N) in x.dtype."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    if k != w.k or k % cfg.array_len:
        raise ValueError(f"fused linear: K={k} vs weight K={w.k}, L_A={cfg.array_len}")
    x2 = x.reshape(-1, k).float().contiguous()
    if s_x is None:
        s_x = bcq.tensor_scale(x2, cfg)
    out = bcq_linear(x2, w.idx_packed, w.sel_packed, w.inv_scale, codebooks, s_x, cfg)
    return out.reshape(*lead, -1).to(x.dtype)


def w4a4_linear_fused_experts(x: torch.Tensor, w: PackedOperand, codebooks: torch.Tensor,
                              cfg: BCQConfig, s_x: torch.Tensor | None = None) -> torch.Tensor:
    """The E fused W4A4 linears of an expert stack in one kernel call.
    x: (E, C, K), row block e through expert e's weight; w: the stack
    (``packed_operand`` of an (E, N, K) stack); ``s_x`` the one
    per-tensor activation scale of every expert (default: the reduction
    over all of x, padding rows included, as ``moe.py:65``).  Returns (E,
    C, N) in x.dtype, expert e equal to ``w4a4_linear_fused(x[e], w[e],
    s_x=s_x)``."""
    e, c, k = x.shape
    if k != w.k or k % cfg.array_len or w.idx_packed.shape[0] != e:
        raise ValueError(f"fused expert linear: x {tuple(x.shape)} vs weight stack "
                         f"{tuple(w.idx_packed.shape)}, L_A={cfg.array_len}")
    xf = x.float().contiguous()
    if s_x is None:
        s_x = bcq.tensor_scale(xf, cfg)
    out = bcq_linear_experts(xf, w.idx_packed, w.sel_packed, w.inv_scale, codebooks, s_x, cfg)
    return out.to(x.dtype)
