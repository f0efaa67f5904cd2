"""W4A4 GEMM of two packed operands: the second launch of the two-launch
W4A4 GEMM.

Counterpart of ``repro/kernels/bcq_matmul.py``.  ``bcq_matmul`` launches
csrc/bcq_matmul.cu for CUDA tensors (design notes in the source) and runs
the plain version, ``ref.matmul_ref``, for CPU tensors; meta tensors (the
dry-run) get a meta output and ``matmul_cost``'s count.
"""
from __future__ import annotations

import torch

from repro_torch.core.bcq import (BCQConfig, check_kernel_codebooks, check_kernel_format,
                                  kernel_route)
from repro_torch.kernels import build
from repro_torch.kernels.bcq_linear import pad_weight
from repro_torch.kernels.ref import matmul_ref

BCQ_MATMUL = build.counter("bcq_matmul")


def matmul_cost(m: int, k: int, n: int, cfg: BCQConfig = BCQConfig()) -> tuple:
    """(HBM bytes, operations by unit) in ``cfg``'s format: both packed
    operands and both codebooks read once, the f32 output written once;
    the int8 product on the tensor cores."""
    row = k // 2 + k // (2 * cfg.block_len) + k // cfg.array_len * 4
    nbytes = (m + n) * row + 2 * build.codebook_bytes(cfg) + m * n * 4
    return nbytes, {"int8": 2 * m * n * k}


def bcq_matmul(a_idx, a_sel, a_inv, w_idx, w_sel, w_inv, codebooks_a, codebooks_w,
               cfg: BCQConfig) -> torch.Tensor:
    """out (M, N) f32 = decode(A) · decode(W)ᵀ for packed rows: idx u8
    (R, K/2), sel u8 (R, K/(2·L_b)), inv f32 (R, K/L_A) = 1/(ŝ_A·s_X), in
    any format ``check_kernel_format`` takes with integer codebooks (N_c,
    2^B).  K must be a multiple of L_A: a K that is not one of 64 is padded
    to whole 64-wide steps with zero arrays (``bcq_linear.pad_weight``), as
    the reference's wrapper pads; ragged M and N are masked in the kernel.
    No backward: an input that requires grad under autograd raises."""
    build.refuse_grad("bcq_matmul", a_inv, w_inv, codebooks_a, codebooks_w)
    if a_idx.device.type == "cpu":
        return matmul_ref(a_idx, a_sel, a_inv, w_idx, w_sel, w_inv, codebooks_a, codebooks_w, cfg)
    if a_idx.device.type not in ("cuda", "meta"):
        raise ValueError(f"bcq_matmul: unsupported device {a_idx.device}")
    check_kernel_format(cfg, "bcq_matmul kernel")
    if a_idx.device.type == "cuda":
        check_kernel_codebooks(codebooks_a, cfg)
        check_kernel_codebooks(codebooks_w, cfg)
    m, n, k = a_idx.shape[0], w_idx.shape[0], a_idx.shape[1] * 2
    if k % cfg.array_len:
        raise ValueError(f"bcq_matmul kernel: K={k} is not a multiple of L_A={cfg.array_len}")
    dev = a_idx.device
    sb, na, cbs = k // (2 * cfg.block_len), k // cfg.array_len, (cfg.n_codebooks, cfg.n_entries)
    for name, t, dt, shape in (
        ("a_idx", a_idx, torch.uint8, (m, k // 2)), ("a_sel", a_sel, torch.uint8, (m, sb)),
        ("a_inv", a_inv, torch.float32, (m, na)),
        ("w_idx", w_idx, torch.uint8, (n, k // 2)), ("w_sel", w_sel, torch.uint8, (n, sb)),
        ("w_inv", w_inv, torch.float32, (n, na)),
        ("codebooks_a", codebooks_a, torch.float32, cbs),
        ("codebooks_w", codebooks_w, torch.float32, cbs),
    ):
        build.check_tensor(f"bcq_matmul kernel: {name}", t, dt, shape, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        build.add_meta_cost("bcq_matmul", *matmul_cost(m, k, n, cfg))
        return out
    if m == 0 or n == 0:
        return out
    kp = build.pad_k(k)  # both operands' arrays past K: zero codes, zero scales
    a_idx, a_sel, a_inv = pad_weight(a_idx, a_sel, a_inv, kp, cfg)
    w_idx, w_sel, w_inv = pad_weight(w_idx, w_sel, w_inv, kp, cfg)
    a_idx, w_idx = build.aligned(a_idx, 16), build.aligned(w_idx, 16)  # 16-byte copies
    a_sel, w_sel = build.aligned(a_sel, 4), build.aligned(w_sel, 4)
    status = build.library().bcq_matmul_launch(
        a_idx.data_ptr(), a_sel.data_ptr(), a_inv.data_ptr(), w_idx.data_ptr(),
        w_sel.data_ptr(), w_inv.data_ptr(), codebooks_a.data_ptr(), codebooks_w.data_ptr(),
        out.data_ptr(), m, n, kp, *build.format_args(cfg), int(kernel_route(cfg).special),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(status, "bcq_matmul_launch")
    BCQ_MATMUL.count += 1
    return out
