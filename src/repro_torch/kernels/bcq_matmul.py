"""W4A4 GEMM of two packed operands: the second launch of the two-launch
W4A4 GEMM.

Counterpart of ``repro/kernels/bcq_matmul.py``.  ``bcq_matmul`` launches
csrc/bcq_matmul.cu for CUDA tensors (design notes in the source) and runs
the plain version, ``ref.matmul_ref``, for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.bcq import BCQConfig, check_kernel_codebooks, check_kernel_config
from repro_torch.kernels import build
from repro_torch.kernels.ref import matmul_ref

BCQ_MATMUL = build.counter("bcq_matmul")


def bcq_matmul(a_idx, a_sel, a_inv, w_idx, w_sel, w_inv, codebooks_a, codebooks_w,
               cfg: BCQConfig) -> torch.Tensor:
    """out (M, N) f32 = decode(A) · decode(W)ᵀ for packed rows: idx u8
    (R, K/2), sel u8 (R, K/16), inv f32 (R, K/L_A) = 1/(ŝ_A·s_X).  K must
    be a multiple of L_A; ragged M and N are masked in the kernel."""
    if a_idx.device.type == "cpu":
        return matmul_ref(a_idx, a_sel, a_inv, w_idx, w_sel, w_inv, codebooks_a, codebooks_w, cfg)
    if a_idx.device.type != "cuda":
        raise ValueError(f"bcq_matmul: unsupported device {a_idx.device}")
    check_kernel_config(cfg, "bcq_matmul kernel")
    check_kernel_codebooks(codebooks_a, cfg)
    check_kernel_codebooks(codebooks_w, cfg)
    m, n, k = a_idx.shape[0], w_idx.shape[0], a_idx.shape[1] * 2
    if k % cfg.array_len:
        raise ValueError(f"bcq_matmul kernel: K={k} is not a multiple of {cfg.array_len}")
    dev = a_idx.device
    for name, t, dt, shape in (
        ("a_idx", a_idx, torch.uint8, (m, k // 2)), ("a_sel", a_sel, torch.uint8, (m, k // 16)),
        ("a_inv", a_inv, torch.float32, (m, k // 64)),
        ("w_idx", w_idx, torch.uint8, (n, k // 2)), ("w_sel", w_sel, torch.uint8, (n, k // 16)),
        ("w_inv", w_inv, torch.float32, (n, k // 64)),
        ("codebooks_a", codebooks_a, torch.float32, (8, 16)),
        ("codebooks_w", codebooks_w, torch.float32, (8, 16)),
    ):
        build.check_tensor(f"bcq_matmul kernel: {name}", t, dt, shape, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    a_idx, w_idx = build.aligned(a_idx, 16), build.aligned(w_idx, 16)  # 16-byte copies
    a_sel, w_sel = build.aligned(a_sel, 4), build.aligned(w_sel, 4)
    status = build.library().bcq_matmul_launch(
        a_idx.data_ptr(), a_sel.data_ptr(), a_inv.data_ptr(), w_idx.data_ptr(),
        w_sel.data_ptr(), w_inv.data_ptr(), codebooks_a.data_ptr(), codebooks_w.data_ptr(),
        out.data_ptr(), m, n, k, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "bcq_matmul_launch")
    BCQ_MATMUL.count += 1
    return out
