"""Wrappers around the fused W4A4 linear (counterpart of ``repro/kernels/ops.py``).

The dispatch is by device: CUDA tensors launch the kernel, CPU tensors
run its plain version (see ``kernels/bcq_linear.py``).  The wrapper owns
the per-tensor activation scale: ``s_x`` is one torch reduction over the
whole launch batch (``ops.py:187-190``), so every row of a launch shares
it — the reason the serving engine stages launches exactly like the
reference.  No padding is needed: the kernel masks ragged M and N, and K
must already be a multiple of L_A.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bcq, formats
from repro_torch.core.bcq import BCQConfig
from repro_torch.kernels.bcq_linear import bcq_linear


@dataclasses.dataclass
class PackedOperand:
    idx_packed: torch.Tensor  # uint8 (R, K//2)
    sel_packed: torch.Tensor  # uint8 (R, K//(2·L_b))
    inv_scale: torch.Tensor  # f32  (R, K//L_A) = 1/(ŝ_A·s_X)
    k: int  # reduction length


def packed_operand(pk: dict) -> PackedOperand:
    """View a packed weight dict (``layers.pack_weight`` layout: idx / sel /
    E4M3 scale bits / s_x) as a PackedOperand with the dequant scales
    inverted (zero where never written)."""
    if pk["idx"].ndim != 2:
        raise ValueError("packed_operand takes one (N, K) weight")
    ratio = formats.bits_to_e4m3(pk["scale"])
    inv = torch.where(ratio > 0, 1.0 / (ratio * pk["s_x"]), torch.zeros_like(ratio))
    return PackedOperand(pk["idx"], pk["sel"], inv, pk["idx"].shape[1] * 2)


def w4a4_linear_fused(x: torch.Tensor, w: PackedOperand, codebooks: torch.Tensor,
                      cfg: BCQConfig, s_x: torch.Tensor | None = None) -> torch.Tensor:
    """Single-launch fused W4A4 linear.  x: (..., K); weights pre-encoded
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
