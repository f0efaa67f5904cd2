"""Fused W4A4 linear: encode → decode → GEMM behind one call.

Counterpart of ``repro/kernels/bcq_linear.py``.  ``bcq_linear`` launches
csrc/bcq_linear.cu for CUDA tensors — two device kernels behind one C
entry: the encode pass writes the activation's int8 codewords and
per-array scales into a workspace this wrapper allocates, then the int8
tensor-core GEMM reads them (design notes in the source) — and runs the
plain version, ``ref.fused_linear_ref`` (the encode/decode/matmul
composition the reference's kernel is held to), for CPU tensors.  The
launch counter counts calls, one per fused linear.  Neither the kernel nor
the reference's has a backward, so both wrappers refuse inputs that
require grad while autograd records (``build.refuse_grad``).

``bcq_linear_experts`` is the expert-stacked form of the same launch
pair: the E expert linears of a mixture-of-experts layer, one shared
``s_x``, in one call (the GEMM's grid z is the expert); its plain version
is ``ref.fused_linear_experts_ref``, the per-expert loop.  It counts one
launch per call, on its own counter.

Both take any K that is a whole number of arrays, as the reference's
wrappers do (``repro/kernels/ops.py``: zero arrays with zero dequant
scales past K).  The GEMM walks K in 64-wide steps, so where K is not a
multiple of 64 (K 112 or 80 at L_A 16, K 96 at L_A 32) the wrappers append
zero columns up to the next multiple (``pad_k``): x's extra arrays
encode to finite scales, the weight's carry zero codes and zero
``w_inv``, so each adds ``isum · (a_inv · 0)`` = 0 to every output.  A K
that is a multiple of 64 (every full-width config's) launches on the
caller's tensors as before: no copy, the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.bcq import (BCQConfig, check_kernel_codebooks, check_kernel_format,
                                  kernel_route)
from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_linear_experts_ref, fused_linear_ref

BCQ_LINEAR = build.counter("bcq_linear")
BCQ_LINEAR_EXPERTS = build.counter("bcq_linear_experts")


def linear_cost(e: int, m: int, k: int, n: int, cfg: BCQConfig = BCQConfig()) -> tuple:
    """(HBM bytes, operations by unit) of ``e`` fused linears of M×K by
    N×K sharing one ``s_x``, in ``cfg``'s format: x read and out written in
    f32, each packed weight (idx, sel, dequant scales) and the codebooks
    read once; the int8 product on the tensor cores and the encode (the
    table's or the threshold search's) on the CUDA cores."""
    rows = e * m
    w_bytes = n * k // 2 + n * k // (2 * cfg.block_len) + n * k // cfg.array_len * 4
    nbytes = rows * k * 4 + e * w_bytes + build.codebook_bytes(cfg) + 4 + rows * n * 4
    ops = build.encode_ops(cfg, kernel_route(cfg).table)
    return nbytes, {"int8": 2 * rows * n * k, "f32": ops * rows * k}


def _check_k(what: str, k: int, cfg: BCQConfig) -> None:
    """K must be a whole number of arrays (``pad_weight`` fills the GEMM's
    last 64-wide step)."""
    if k % cfg.array_len:
        raise ValueError(f"{what}: K={k} is not a multiple of L_A={cfg.array_len}")


def pad_weight(w_idx, w_sel, w_inv, kp: int, cfg: BCQConfig) -> tuple:
    """A packed weight (..., N, K) widened to ``kp`` columns with zero
    arrays: zero idx and sel bytes, zero dequant scales (whole bytes: K is
    a multiple of L_A, itself of 2·L_b)."""
    return (build.pad_last(w_idx, kp // 2), build.pad_last(w_sel, kp // (2 * cfg.block_len)),
            build.pad_last(w_inv, kp // cfg.array_len))


def bcq_linear(x, w_idx, w_sel, w_inv, codebooks, s_x, cfg: BCQConfig) -> torch.Tensor:
    """Fused W4A4 linear: raw x (M, K) f32 + packed weights → f32 (M, N).

    w_idx (N, K/2) uint8, w_sel (N, K/(2·L_b)) uint8, w_inv (N, K/L_A) f32
    = 1/(ŝ_A·s_W) (zero where never written); s_x: the per-tensor
    activation scale, a 0-d tensor the caller reduced over the whole
    launch batch; any format ``check_kernel_format`` takes, with integer
    codebooks (N_c, 2^B).  K must be a multiple of L_A (padded to whole
    64-wide steps here when it is not one of 64); ragged M and N are
    masked in the kernel.
    No backward: an input that requires grad under autograd raises."""
    build.refuse_grad("bcq_linear", x, w_inv, codebooks, s_x)
    if x.device.type == "cpu":
        return fused_linear_ref(x, w_idx, w_sel, w_inv, codebooks, cfg, s_x,
                                valid_k=x.shape[1])
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"bcq_linear: unsupported device {x.device}")
    check_kernel_format(cfg, "bcq_linear kernel")
    if x.device.type == "cuda":
        check_kernel_codebooks(codebooks, cfg)
    m, k = x.shape
    n = w_idx.shape[0]
    _check_k("bcq_linear kernel", k, cfg)
    for name, t, dt, shape in (
        ("x", x, torch.float32, (m, k)), ("w_idx", w_idx, torch.uint8, (n, k // 2)),
        ("w_sel", w_sel, torch.uint8, (n, k // (2 * cfg.block_len))),
        ("w_inv", w_inv, torch.float32, (n, k // cfg.array_len)),
        ("codebooks", codebooks, torch.float32, (cfg.n_codebooks, cfg.n_entries)),
        ("s_x", s_x, torch.float32, ()),
    ):
        build.check_tensor(f"bcq_linear kernel: {name}", t, dt, shape, x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        build.add_meta_cost("bcq_linear", *linear_cost(1, m, k, n, cfg))
        return out
    if m == 0 or n == 0:
        return out
    kp = build.pad_k(k)
    x = build.pad_last(x, kp)
    w_idx, w_sel, w_inv = pad_weight(w_idx, w_sel, w_inv, kp, cfg)
    x, w_idx = build.aligned(x, 16), build.aligned(w_idx, 16)  # read in 16-byte words
    w_sel = build.aligned(w_sel, 4)
    codes = torch.empty((m, kp), dtype=torch.int8, device=x.device)  # encode-pass workspace
    a_inv = torch.empty((m, kp // cfg.array_len), dtype=torch.float32, device=x.device)
    status = build.library().bcq_linear_launch(
        x.data_ptr(), w_idx.data_ptr(), w_sel.data_ptr(), w_inv.data_ptr(),
        codebooks.data_ptr(), s_x.data_ptr(), codes.data_ptr(), a_inv.data_ptr(),
        out.data_ptr(), m, n, kp, cfg.codeword_max, *build.format_args(cfg),
        *map(int, kernel_route(cfg)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "bcq_linear_launch")
    BCQ_LINEAR.count += 1
    return out


def bcq_linear_experts(x, w_idx, w_sel, w_inv, codebooks, s_x, cfg: BCQConfig) -> torch.Tensor:
    """Expert-stacked fused W4A4 linear: raw x (E, C, K) f32 against E
    packed weights — w_idx (E, N, K/2), w_sel (E, N, K/(2·L_b)), w_inv (E,
    N, K/L_A) — with one shared s_x → f32 (E, C, N).  Expert e's output has
    the bits of ``bcq_linear(x[e], w_idx[e], …)`` (the tile shape follows
    C, not E·C).  No backward, as ``bcq_linear``."""
    build.refuse_grad("bcq_linear_experts", x, w_inv, codebooks, s_x)
    if x.device.type == "cpu":
        return fused_linear_experts_ref(x, w_idx, w_sel, w_inv, codebooks, cfg, s_x)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"bcq_linear_experts: unsupported device {x.device}")
    check_kernel_format(cfg, "bcq_linear_experts kernel")
    if x.device.type == "cuda":
        check_kernel_codebooks(codebooks, cfg)
    e, c, k = x.shape
    n = w_idx.shape[1]
    _check_k("bcq_linear_experts kernel", k, cfg)
    if not 1 <= e <= 65535:
        raise ValueError(f"bcq_linear_experts kernel: E={e} is not in [1, 65535]")
    for name, t, dt, shape in (
        ("x", x, torch.float32, (e, c, k)), ("w_idx", w_idx, torch.uint8, (e, n, k // 2)),
        ("w_sel", w_sel, torch.uint8, (e, n, k // (2 * cfg.block_len))),
        ("w_inv", w_inv, torch.float32, (e, n, k // cfg.array_len)),
        ("codebooks", codebooks, torch.float32, (cfg.n_codebooks, cfg.n_entries)),
        ("s_x", s_x, torch.float32, ()),
    ):
        build.check_tensor(f"bcq_linear_experts kernel: {name}", t, dt, shape, x.device)
    out = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        build.add_meta_cost("bcq_linear_experts", *linear_cost(e, c, k, n, cfg))
        return out
    if c == 0 or n == 0:
        return out
    kp = build.pad_k(k)
    x = build.pad_last(x, kp)
    w_idx, w_sel, w_inv = pad_weight(w_idx, w_sel, w_inv, kp, cfg)
    x, w_idx = build.aligned(x, 16), build.aligned(w_idx, 16)  # read in 16-byte words
    w_sel = build.aligned(w_sel, 4)
    codes = torch.empty((e * c, kp), dtype=torch.int8, device=x.device)  # encode-pass workspace
    a_inv = torch.empty((e * c, kp // cfg.array_len), dtype=torch.float32, device=x.device)
    status = build.library().bcq_linear_experts_launch(
        x.data_ptr(), w_idx.data_ptr(), w_sel.data_ptr(), w_inv.data_ptr(),
        codebooks.data_ptr(), s_x.data_ptr(), codes.data_ptr(), a_inv.data_ptr(),
        out.data_ptr(), e, c, n, kp, cfg.codeword_max, *build.format_args(cfg),
        *map(int, kernel_route(cfg)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(status, "bcq_linear_experts_launch")
    BCQ_LINEAR_EXPERTS.count += 1
    return out
