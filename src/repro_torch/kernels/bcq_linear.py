"""Fused W4A4 linear: encode → decode → GEMM behind one call.

Counterpart of ``repro/kernels/bcq_linear.py``.  ``bcq_linear`` launches
csrc/bcq_linear.cu for CUDA tensors — two device kernels behind one C
entry: the encode pass writes the activation's int8 codewords and
per-array scales into a workspace this wrapper allocates, then the int8
tensor-core GEMM reads them (design notes in the source) — and runs the
plain version, ``ref.fused_linear_ref`` (the encode/decode/matmul
composition the reference's kernel is held to), for CPU tensors.  The
launch counter counts calls, one per fused linear.

``bcq_linear_experts`` is the expert-stacked form of the same launch
pair: the E expert linears of a mixture-of-experts layer, one shared
``s_x``, in one call (the GEMM's grid z is the expert); its plain version
is ``ref.fused_linear_experts_ref``, the per-expert loop.  It counts one
launch per call, on its own counter.
"""
from __future__ import annotations

import torch

from repro_torch.core.bcq import BCQConfig, check_kernel_codebooks, check_kernel_config
from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_linear_experts_ref, fused_linear_ref

BCQ_LINEAR = build.counter("bcq_linear")
BCQ_LINEAR_EXPERTS = build.counter("bcq_linear_experts")


def bcq_linear(x, w_idx, w_sel, w_inv, codebooks, s_x, cfg: BCQConfig) -> torch.Tensor:
    """Fused W4A4 linear: raw x (M, K) f32 + packed weights → f32 (M, N).

    w_idx (N, K/2) uint8, w_sel (N, K/16) uint8, w_inv (N, K/L_A) f32 =
    1/(ŝ_A·s_W) (zero where never written); s_x: the per-tensor activation
    scale, a 0-d tensor the caller reduced over the whole launch batch.
    K must be a multiple of L_A; ragged M and N are masked in the kernel."""
    if x.device.type == "cpu":
        return fused_linear_ref(x, w_idx, w_sel, w_inv, codebooks, cfg, s_x,
                                valid_k=x.shape[1])
    if x.device.type != "cuda":
        raise ValueError(f"bcq_linear: unsupported device {x.device}")
    check_kernel_config(cfg, "bcq_linear kernel")
    check_kernel_codebooks(codebooks, cfg)
    m, k = x.shape
    n = w_idx.shape[0]
    if k % cfg.array_len:
        raise ValueError(f"bcq_linear kernel: K={k} is not a multiple of {cfg.array_len}")
    for name, t, dt, shape in (
        ("x", x, torch.float32, (m, k)), ("w_idx", w_idx, torch.uint8, (n, k // 2)),
        ("w_sel", w_sel, torch.uint8, (n, k // 16)), ("w_inv", w_inv, torch.float32, (n, k // 64)),
        ("codebooks", codebooks, torch.float32, (8, 16)), ("s_x", s_x, torch.float32, ()),
    ):
        build.check_tensor(f"bcq_linear kernel: {name}", t, dt, shape, x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    x, w_idx = build.aligned(x, 16), build.aligned(w_idx, 16)  # read in 16-byte words
    w_sel = build.aligned(w_sel, 4)
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)  # encode-pass workspace
    a_inv = torch.empty((m, k // 64), dtype=torch.float32, device=x.device)
    status = build.library().bcq_linear_launch(
        x.data_ptr(), w_idx.data_ptr(), w_sel.data_ptr(), w_inv.data_ptr(),
        codebooks.data_ptr(), s_x.data_ptr(), codes.data_ptr(), a_inv.data_ptr(),
        out.data_ptr(), m, n, k, cfg.codeword_max,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "bcq_linear_launch")
    BCQ_LINEAR.count += 1
    return out


def bcq_linear_experts(x, w_idx, w_sel, w_inv, codebooks, s_x, cfg: BCQConfig) -> torch.Tensor:
    """Expert-stacked fused W4A4 linear: raw x (E, C, K) f32 against E
    packed weights — w_idx (E, N, K/2), w_sel (E, N, K/16), w_inv (E, N,
    K/L_A) — with one shared s_x → f32 (E, C, N).  Expert e's output has
    the bits of ``bcq_linear(x[e], w_idx[e], …)`` (the tile shape follows
    C, not E·C)."""
    if x.device.type == "cpu":
        return fused_linear_experts_ref(x, w_idx, w_sel, w_inv, codebooks, cfg, s_x)
    if x.device.type != "cuda":
        raise ValueError(f"bcq_linear_experts: unsupported device {x.device}")
    check_kernel_config(cfg, "bcq_linear_experts kernel")
    check_kernel_codebooks(codebooks, cfg)
    e, c, k = x.shape
    n = w_idx.shape[1]
    if k % cfg.array_len or not 1 <= e <= 65535:
        raise ValueError(f"bcq_linear_experts kernel: E={e}, K={k} (K % {cfg.array_len})")
    for name, t, dt, shape in (
        ("x", x, torch.float32, (e, c, k)), ("w_idx", w_idx, torch.uint8, (e, n, k // 2)),
        ("w_sel", w_sel, torch.uint8, (e, n, k // 16)),
        ("w_inv", w_inv, torch.float32, (e, n, k // 64)),
        ("codebooks", codebooks, torch.float32, (8, 16)), ("s_x", s_x, torch.float32, ()),
    ):
        build.check_tensor(f"bcq_linear_experts kernel: {name}", t, dt, shape, x.device)
    out = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    if c == 0 or n == 0:
        return out
    x, w_idx = build.aligned(x, 16), build.aligned(w_idx, 16)  # read in 16-byte words
    w_sel = build.aligned(w_sel, 4)
    codes = torch.empty((e * c, k), dtype=torch.int8, device=x.device)  # encode-pass workspace
    a_inv = torch.empty((e * c, k // 64), dtype=torch.float32, device=x.device)
    status = build.library().bcq_linear_experts_launch(
        x.data_ptr(), w_idx.data_ptr(), w_sel.data_ptr(), w_inv.data_ptr(),
        codebooks.data_ptr(), s_x.data_ptr(), codes.data_ptr(), a_inv.data_ptr(),
        out.data_ptr(), e, c, n, k, cfg.codeword_max,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "bcq_linear_experts_launch")
    BCQ_LINEAR_EXPERTS.count += 1
    return out
