"""E4M3 scale format of LO-BCQ (paper §A.4), in PyTorch.

Counterpart of ``repro/core/formats.py`` for the formats the serving
path needs: ``FloatFormat.quantize`` (round to nearest even on the
mantissa, saturating), its OCP E4M3 instance, and the E4M3 ↔ uint8 bit
pattern codecs.  Rounding must match the reference bit for bit:

* ``torch.round`` rounds half to even, like ``jnp.round``;
* the exponent is ``floor(log2(max(a, 1e-38)))`` clamped to the format's
  range, never a ``float8_e4m3fn`` cast (which rounds differently at the
  subnormal floor and saturates differently);
* powers of two are built from their bit pattern (``pow2``), so they are
  exact on every device.
"""
from __future__ import annotations

import dataclasses

import torch


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact f32 ``2**e`` for integer-valued ``e`` in [-126, 127]."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """EeMm minifloat, round-to-nearest-even on the mantissa, saturating.
    ``ocp_e4m3`` reserves the top mantissa code at the top exponent (max
    448) as in the OCP FP8 spec."""

    exp_bits: int
    man_bits: int
    ocp_e4m3: bool = False

    @property
    def bias(self) -> int:
        return 2 ** (self.exp_bits - 1) - 1

    @property
    def max_val(self) -> float:
        emax = (2**self.exp_bits - 1) - self.bias
        if self.ocp_e4m3:
            return float(2.0**emax * (2.0 - 2.0 ** (1 - self.man_bits)))
        return float(2.0**emax * (2.0 - 2.0 ** (-self.man_bits)))

    @property
    def min_subnormal(self) -> float:
        return float(2.0 ** (1 - self.bias) * 2.0 ** (-self.man_bits))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.float()
        sign = torch.sign(x)
        a = x.abs()
        e = torch.floor(torch.log2(torch.clamp_min(a, 1e-38)))
        e = e.clamp(1 - self.bias, (2**self.exp_bits - 1) - self.bias)
        ulp = pow2(e - self.man_bits)
        q = torch.round(a / ulp) * ulp
        q = torch.clamp_max(q, self.max_val)
        q = torch.where(a == 0.0, torch.zeros_like(q), q)
        return (sign * q).to(dt)


E4M3 = FloatFormat(4, 3, ocp_e4m3=True)  # OCP FP8: max 448


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
