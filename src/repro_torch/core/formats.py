"""Number formats and round-to-nearest quantizers (paper §A.4), in PyTorch.

Counterpart of ``repro/core/formats.py``: ``IntFormat(n)`` (symmetric
n-bit integer grid), ``FloatFormat(e, m)`` (EeMm minifloat with
subnormals, round to nearest even on the mantissa, saturating; E4M3 with
the OCP 448 max), ``E8M0`` (the power-of-two MX block scale), the
per-tensor max scaling of Eqs. 13/14 (``quantize_tensor_scaled``), and
the E4M3 ↔ uint8 bit pattern codecs.  Values must match the reference's
bit for bit:

* ``torch.round`` rounds half to even, like ``jnp.round``;
* the exponent is ``floor(log2(max(a, 1e-38)))`` clamped to the format's
  range, never a ``float8_e4m3fn`` cast (which rounds differently at the
  subnormal floor and saturates differently);
* powers of two are built from their bit pattern (``pow2``), so they are
  exact on every device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact f32 ``2**e`` for integer-valued ``e`` in [-126, 127]."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class IntFormat:
    """n-bit symmetric integer grid, ±(2^(n-1)-1)."""

    bits: int

    @property
    def max_val(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    @property
    def name(self) -> str:
        return f"INT{self.bits}"

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x), -self.max_val, self.max_val)

    def levels(self) -> np.ndarray:
        m = int(self.max_val)
        return np.arange(-m, m + 1, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """EeMm minifloat, round-to-nearest-even on the mantissa, saturating.
    ``bias`` defaults to 2^(e-1)-1.  ``ocp_e4m3`` reserves the top mantissa
    code at the top exponent (max 448) as in the OCP FP8 spec."""

    exp_bits: int
    man_bits: int
    bias: int | None = None
    ocp_e4m3: bool = False

    @property
    def name(self) -> str:
        return f"E{self.exp_bits}M{self.man_bits}"

    @property
    def _bias(self) -> int:
        return self.bias if self.bias is not None else 2 ** (self.exp_bits - 1) - 1

    @property
    def max_val(self) -> float:
        emax = (2**self.exp_bits - 1) - self._bias
        if self.ocp_e4m3:
            return float(2.0**emax * (2.0 - 2.0 ** (1 - self.man_bits)))
        return float(2.0**emax * (2.0 - 2.0 ** (-self.man_bits)))

    @property
    def min_subnormal(self) -> float:
        return float(2.0 ** (1 - self._bias) * 2.0 ** (-self.man_bits))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.float()
        sign = torch.sign(x)
        a = x.abs()
        e = torch.floor(torch.log2(torch.clamp_min(a, 1e-38)))
        e = e.clamp(1 - self._bias, (2**self.exp_bits - 1) - self._bias)
        ulp = pow2(e - self.man_bits)
        q = torch.round(a / ulp) * ulp
        q = torch.clamp_max(q, self.max_val)
        q = torch.where(a == 0.0, torch.zeros_like(q), q)
        return (sign * q).to(dt)

    def levels(self) -> np.ndarray:
        """All non-negative representable values."""
        vals = {0.0}
        for code_e in range(2**self.exp_bits):
            for code_m in range(2**self.man_bits):
                if code_e == 0:  # subnormal
                    v = 2.0 ** (1 - self._bias) * (code_m * 2.0 ** (-self.man_bits))
                else:
                    v = 2.0 ** (code_e - self._bias) * (1.0 + code_m * 2.0 ** (-self.man_bits))
                if v <= self.max_val + 1e-12:
                    vals.add(v)
        return np.array(sorted(vals), dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class E8M0Format:
    """Power-of-two scale format of MX: value = 2^k, k in [-127, 127]."""

    @property
    def name(self) -> str:
        return "E8M0"

    @property
    def max_val(self) -> float:
        return float(2.0**127)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        a = x.float().abs()
        k = torch.round(torch.log2(torch.clamp_min(a, 1e-38))).clamp(-127, 127)
        q = torch.where(a == 0.0, torch.zeros_like(a), _exp2(k))
        return (torch.sign(x.float()) * q).to(dt)


def _exp2(k: torch.Tensor) -> torch.Tensor:
    """Exact f32 2**k for integer k in [-127, 127]: 2^-127 is subnormal, so
    it is built as 2^-126 · 0.5 (exact), not from an exponent field."""
    return torch.where(k < -126, pow2(torch.clamp_min(k + 1, -126)) * 0.5,
                       pow2(torch.clamp_min(k, -126)))


# --- canonical instances -------------------------------------------------
INT4 = IntFormat(4)
INT6 = IntFormat(6)
INT8 = IntFormat(8)

E4M3 = FloatFormat(4, 3, ocp_e4m3=True)  # OCP FP8: max 448
E5M2 = FloatFormat(5, 2)
E2M1 = FloatFormat(2, 1)  # MXFP4 element format, max 6.0
E1M2 = FloatFormat(1, 2)  # the paper's proxy for MX4, max 3.5
E3M0 = FloatFormat(3, 0)
E8M0 = E8M0Format()

FORMATS = {
    f.name: f
    for f in [INT4, INT6, INT8, E4M3, E5M2, E2M1, E1M2, E3M0, FloatFormat(3, 2), FloatFormat(3, 3)]
}
FORMATS["E8M0"] = E8M0


def quantize_tensor_scaled(x: torch.Tensor, fmt, axis=None) -> torch.Tensor:
    """Dynamic max-scaled quantization (Eqs. 13/14): ``axis=None`` is one
    per-tensor scale, else the scale is reduced over ``axis`` (kept)."""
    xa = x.abs()
    amax = xa.amax() if axis is None else xa.amax(dim=axis, keepdim=True)
    s = amax / torch.full_like(amax, fmt.max_val)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return (fmt.quantize(x / s) * s).to(x.dtype)


def e4m3_to_bits(x: torch.Tensor) -> torch.Tensor:
    """E4M3-grid-snapped positive scales → their uint8 bit pattern."""
    a = x.float().abs()
    e = torch.floor(torch.log2(torch.clamp_min(a, 1e-38))).clamp(-6, 8)
    frac = a / pow2(e)  # in [1, 2) for normals
    is_sub = a < 2.0**-6
    man = torch.where(
        is_sub, torch.round(a / (2.0**-6 * 0.125)), torch.round((frac - 1.0) * 8)
    )
    code_e = torch.where(is_sub, torch.zeros_like(e), e + 7).to(torch.uint8)
    man = man.clamp(0, 7).to(torch.uint8)
    return code_e * 8 + man


def bits_to_e4m3(code: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`e4m3_to_bits` (positive scales only)."""
    code = code.to(torch.int32)
    code_e = code // 8
    man = (code % 8).float()
    sub = 2.0**-6 * (man * 0.125)
    nrm = pow2(code_e - 7) * (1.0 + man * 0.125)
    return torch.where(code_e == 0, sub, nrm)
