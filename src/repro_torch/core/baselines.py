"""Block-quantization baselines the paper compares against (§4.1, §A.5),
in PyTorch (counterpart of ``repro/core/baselines.py``).

All are fake-quant functions ``x -> x_q`` (same shape and dtype, values
snapped to each scheme's grid), blocks along the last axis:

* MX4 (g16) — 16-scalar blocks, E8M0 shared scale, E1M2 elements (the
  paper's deliberately optimistic proxy for MX4), 4.5 bits;
* MXFP4 (g32) — 32-scalar blocks, E8M0 scale, E2M1 elements, 4.25 bits;
* VSQ (g16) — 16-scalar vectors, INT4 elements, a per-vector scale
  quantized to UINT8 against a per-tensor scale (two levels), 4.5 bits;
* INT4 / INT8 per tensor, EeMm per tensor, Lloyd-Max per tensor (Table 11).

Values equal the reference's bit for bit, except ``lloydmax_pertensor``,
whose Lloyd-Max sums add in another order (``core/lloyd_max.py``), and
where a scale falls below f32's normal range (XLA on the CPU flushes
subnormals to zero).  The reference jits ``mx_quantize``,
``mxfp4_quantize``, ``vsq_quantize`` and ``int_pertensor``, and XLA
compiles a division by a constant into a product with the constant's
f32 reciprocal; those divisions are such products here too (``_over``).
``fp_pertensor`` is not jitted there, and divides.
"""
from __future__ import annotations

import torch

from repro_torch.core import formats
from repro_torch.core.bcq import pad_to_multiple
from repro_torch.core.lloyd_max import lloyd_max_1d, quantile_init, quantize_to_levels


def _blockwise(x: torch.Tensor, block: int):
    xp, _ = pad_to_multiple(x.float(), block)
    b = xp.reshape(*xp.shape[:-1], xp.shape[-1] // block, block)
    return b, b.abs().amax(dim=-1, keepdim=True)


def _unblock(b: torch.Tensor, orig_last: int, dtype) -> torch.Tensor:
    out = b.reshape(*b.shape[:-2], b.shape[-2] * b.shape[-1])
    return out[..., :orig_last].to(dtype)


def _over(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as a jitted reference computes it: a · f32(1 / c)."""
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return a * (one / torch.full_like(one, c))


def _mx(x: torch.Tensor, block: int, fmt: formats.FloatFormat) -> torch.Tensor:
    b, amax = _blockwise(x, block)
    s = torch.where(amax > 0, _over(amax, fmt.max_val), torch.ones_like(amax))
    s = formats.E8M0.quantize(s)
    s = torch.where(s == 0, torch.full_like(s, 2.0**-127), s)
    return _unblock(fmt.quantize(b / s) * s, x.shape[-1], x.dtype)


def mx_quantize(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """MX4 (g16): E8M0 block scale, E1M2 elements (the paper's MX4 proxy)."""
    return _mx(x, block, formats.E1M2)


def mxfp4_quantize(x: torch.Tensor, block: int = 32) -> torch.Tensor:
    """MXFP4 (g32): E8M0 block scale, E2M1 elements."""
    return _mx(x, block, formats.E2M1)


def vsq_quantize(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """VSQ (g16): INT4 elements, UINT8 two-level per-vector scales."""
    b, amax = _blockwise(x, block)
    m = formats.INT4.max_val
    tmax = x.float().abs().amax()
    s_t = torch.where(tmax > 0, _over(tmax, m), torch.ones_like(tmax))
    s_v = torch.where(amax > 0, _over(amax, m), s_t)
    u = s_v / s_t  # in (0, 1]
    # u_q · s_t with u_q = round(255 u) / 255; XLA folds the reciprocal of
    # 255 into the scalar s_t first, so the product is taken in that order
    s = torch.clamp(torch.round(u * 255.0), 1.0, 255.0) * _over(s_t, 255.0)
    return _unblock(formats.INT4.quantize(b / s) * s, x.shape[-1], x.dtype)


def int_pertensor(x: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Per-tensor max-scaled INT-``bits`` (``formats.quantize_tensor_scaled``
    with the jitted reference's reciprocal scale)."""
    fmt = formats.IntFormat(bits)
    amax = x.abs().amax()
    s = _over(amax, fmt.max_val)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return (fmt.quantize(x / s) * s).to(x.dtype)


def fp_pertensor(x: torch.Tensor, fmt: formats.FloatFormat) -> torch.Tensor:
    return formats.quantize_tensor_scaled(x, fmt)


def lloydmax_pertensor(x: torch.Tensor, bits: int = 4, iters: int = 60) -> torch.Tensor:
    """MSE-optimal per-tensor scalar quantizer (paper §A.1, Table 11)."""
    flat = x.reshape(-1).float()
    levels = lloyd_max_1d(flat, quantile_init(flat, 2**bits), iters=iters)
    return quantize_to_levels(x.float(), levels).to(x.dtype)


# name -> (fn, effective bits per scalar) for the benchmark tables
BASELINES = {
    "MX4_g16": (mx_quantize, 4.5),
    "MXFP4_g32": (mxfp4_quantize, 4.25),
    "VSQ_g16": (vsq_quantize, 4.5),
    "INT4_pt": (lambda x: int_pertensor(x, 4), 4.0),
    "LloydMax4_pt": (lambda x: lloydmax_pertensor(x, 4), 4.0),
}
