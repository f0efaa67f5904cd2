"""LO-BCQ encode of an operand: the first launch of the two-launch W4A4 GEMM.

Counterpart of ``repro/kernels/bcq_quantize.py``.  ``bcq_quantize``
launches csrc/bcq_quantize.cu for CUDA tensors (design notes in the
source) and runs the plain version, ``ref.quantize_ref``, for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.bcq import BCQConfig
from repro_torch.kernels import build
from repro_torch.kernels.ref import quantize_ref

BCQ_QUANTIZE = build.counter("bcq_quantize")


def bcq_quantize(x: torch.Tensor, codebooks: torch.Tensor, s_x: torch.Tensor, cfg: BCQConfig):
    """Encode x (M, K) f32 with the per-tensor scale ``s_x`` (a 0-d
    tensor) → (idx u8 (M, K/2), sel u8 (M, K/16), ratio f32 (M, K/L_A)).
    K must be a multiple of L_A."""
    if x.device.type == "cpu":
        return quantize_ref(x, codebooks, cfg, s_x)
    if x.device.type != "cuda":
        raise ValueError(f"bcq_quantize: unsupported device {x.device}")
    if (cfg.array_len, cfg.block_len, cfg.n_entries, cfg.n_codebooks) != (64, 8, 16, 8):
        raise ValueError(f"bcq_quantize kernel: unsupported BCQ config {cfg}")
    m, k = x.shape
    if k % cfg.array_len:
        raise ValueError(f"bcq_quantize kernel: K={k} is not a multiple of {cfg.array_len}")
    for name, t, dt, shape in (("x", x, torch.float32, (m, k)),
                               ("codebooks", codebooks, torch.float32, (8, 16)),
                               ("s_x", s_x, torch.float32, ())):
        build.check_tensor(f"bcq_quantize kernel: {name}", t, dt, shape, x.device)
    x = build.aligned(x, 16)  # the kernel reads x as float4
    idx = torch.empty((m, k // 2), dtype=torch.uint8, device=x.device)
    sel = torch.empty((m, k // 16), dtype=torch.uint8, device=x.device)
    ratio = torch.empty((m, k // 64), dtype=torch.float32, device=x.device)
    if m == 0:
        return idx, sel, ratio
    status = build.library().bcq_quantize_launch(
        x.data_ptr(), codebooks.data_ptr(), s_x.data_ptr(), idx.data_ptr(), sel.data_ptr(),
        ratio.data_ptr(), m, k, cfg.codeword_max,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "bcq_quantize_launch")
    BCQ_QUANTIZE.count += 1
    return idx, sel, ratio
