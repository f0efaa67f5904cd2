"""LO-BCQ: block clustered quantization (paper §2) — PyTorch reference.

Counterpart of ``repro/core/bcq.py``: encode / decode / fake-quant, and
the offline LO-BCQ fit of the codebooks (``fit_lobcq``, §2.2).  Pipeline:

  tensor X --(blocks along the last axis)--> arrays of L_A scalars
    s_X  = (2^(B_c-1)-1) / amax|X|                  per-tensor scale
    s_A  = (2^(B_c-1)-1) / amax|A|                  per-array scale
    ŝ_A  = Q_E4M3(s_A / s_X)                        8-bit stored scale
    y    = X · ŝ_A · s_X                            normalized into ±31
  each block b (L_b scalars of y):
    sel(b) = argmin_i ||b - C_i(b)||²               first minimum wins
    idx[l] = nearest entry of C_sel                 midpoints round up
  decode:  x̂ = C_sel[idx] / (ŝ_A · s_X)

Tie rules follow the reference: ``searchsorted(right=True)`` over the
midpoint thresholds, a strict ``<`` running argmin over the codebooks,
and the block error summed left to right over its L_b scalars — the same
order the CUDA encode (csrc/bcq_linear.cu) uses, so the two are bit
identical.

``fake_quant`` of a CUDA tensor encodes through the quantize kernel (B3,
``kernels/bcq_quantize.py``) and decodes in torch; ``fake_quant_plain``
is the ``encode`` route on any device, its plain version.
"""
from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.core.lloyd_max import (kmeanspp_seeds, lloyd_max_batched, permutation,
                                        quantile_init, split, uniform)
from repro_torch.serving import prng


@dataclasses.dataclass(frozen=True)
class BCQConfig:
    """LO-BCQ format hyper-parameters (Table 1)."""

    block_len: int = 8  # L_b
    array_len: int = 64  # L_A (scalars per block array)
    n_codebooks: int = 8  # N_c
    index_bits: int = 4  # B
    scale_bits: int = 8  # B_s (E4M3)
    codeword_bits: int = 6  # B_c (INT6)

    def __post_init__(self):
        if self.array_len % self.block_len:
            raise ValueError("L_A must be a multiple of L_b")

    @property
    def n_entries(self) -> int:
        return 2**self.index_bits

    @property
    def blocks_per_array(self) -> int:
        return self.array_len // self.block_len

    @property
    def codeword_max(self) -> float:
        return float(2 ** (self.codeword_bits - 1) - 1)

    @property
    def selector_bits(self) -> float:
        return float(np.log2(self.n_codebooks))

    def bitwidth(self, tensor_size: int | None = None) -> float:
        """Effective bits per scalar (Eq. 9); with ``tensor_size`` the
        codebooks' own bits are spread over that many scalars."""
        bw = (
            self.index_bits
            + self.selector_bits / self.block_len
            + self.scale_bits / self.array_len
        )
        if tensor_size:
            bw += self.n_codebooks * self.n_entries * self.codeword_bits / tensor_size
        return bw

    def tag(self) -> str:
        return f"g{self.array_len}_Lb{self.block_len}_Nc{self.n_codebooks}"


@dataclasses.dataclass
class CodebookSet:
    """N_c codebooks, levels sorted ascending per codebook: INT-(B_c)
    integers from a fit with ``quantize_codewords=True`` (what the kernels
    take, ``check_kernel_codebooks``), or the raw Lloyd-Max levels
    otherwise (legitimate for ``fake`` mode, run in plain torch)."""

    levels: np.ndarray  # (N_c, 2^B) float32
    cfg: BCQConfig
    history: list | None = None  # calibration MSE trajectory

    def __post_init__(self):
        if np.any(np.diff(np.asarray(self.levels, dtype=np.float32), axis=-1) < 0):
            raise ValueError("codebook levels must be sorted ascending")

    def as_tensor(self, device="cpu") -> torch.Tensor:
        return torch.as_tensor(self.levels, dtype=torch.float32, device=device)

    def nbytes(self) -> float:
        return self.levels.size * self.cfg.codeword_bits / 8.0

    def save(self, path: str) -> None:
        """The reference's JSON: levels, cfg and history."""
        with open(path, "w") as f:
            json.dump(
                {
                    "levels": np.asarray(self.levels).tolist(),
                    "cfg": dataclasses.asdict(self.cfg),
                    "history": list(map(float, self.history or [])),
                },
                f,
            )

    @staticmethod
    def load(path: str) -> "CodebookSet":
        with open(path) as f:
            d = json.load(f)
        return CodebookSet(levels=np.asarray(d["levels"], dtype=np.float32),
                           cfg=BCQConfig(**d["cfg"]), history=d.get("history"))


def check_codebook_levels(levels: np.ndarray, cfg: BCQConfig) -> None:
    """The premise of the W4A4 kernels: they multiply codewords as int8
    integers and find the nearest entry by a table over floor(2y), both
    exact only for sorted integer levels within ±codeword_max
    (csrc/bcq_encode.cuh, csrc/bcq_gemm.cuh).  Raises ValueError."""
    lv = np.asarray(levels, dtype=np.float32)
    if not np.array_equal(lv, np.round(lv)):
        raise ValueError("codebook levels must be integers (INT codewords)")
    if np.any(np.diff(lv, axis=-1) < 0):
        raise ValueError("codebook levels must be sorted ascending")
    if np.any(np.abs(lv) > cfg.codeword_max):
        raise ValueError(f"codebook levels must lie within ±{cfg.codeword_max:g}")


def check_kernel_codebooks(codebooks: torch.Tensor, cfg: BCQConfig) -> None:
    """``check_codebook_levels`` at a kernel's entry.  The check reads the
    values on the host, a copy that a CUDA graph capture cannot make and a
    launch should not wait for, so a tensor that passed keeps the in-place
    version it passed at (``_kernel_checked``): a later launch on it, a
    captured one after its eager warm-up too, reads one attribute."""
    if getattr(codebooks, "_kernel_checked", None) == codebooks._version:
        return
    check_codebook_levels(codebooks.detach().cpu().numpy(), cfg)
    codebooks._kernel_checked = codebooks._version


def check_kernel_config(cfg: BCQConfig, what: str) -> None:
    """Refuse a config that B1, B3 and B4 cannot run (they are built for
    ``BCQConfig()``'s (L_A, L_b, entries, N_c)): at their entry, and up
    front where an entry point on the card (``what``) would reach them."""
    got = (cfg.array_len, cfg.block_len, cfg.n_entries, cfg.n_codebooks)
    if got != (64, 8, 16, 8):
        raise ValueError(
            f"{what}: the CUDA kernels take only L_A 64, L_b 8, 16 entries and N_c 8 "
            f"(BCQConfig()), not L_A {got[0]}, L_b {got[1]}, {got[2]} entries, N_c {got[3]}; "
            "run this config on the CPU (device='cpu')")


class Encoded(NamedTuple):
    """Bit-true packed LO-BCQ tensor."""

    packed_idx: torch.Tensor  # uint8 (..., Kp//2)   two 4-bit indices / byte
    packed_sel: torch.Tensor  # uint8 (..., ceil(n_blocks/2)) two selectors / byte
    scale_code: torch.Tensor  # uint8 (..., n_arrays) E4M3 bit patterns of ŝ_A
    s_x: torch.Tensor  # f32 scalar per-tensor scale


# ------------------------------------------------------------------ helpers
def pad_to_multiple(x: torch.Tensor, mult: int):
    """Zero-pad the last axis to a multiple of ``mult``."""
    pad = (-x.shape[-1]) % mult
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, pad


def pack_nibbles(x: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit values (last axis, even length) two per uint8."""
    x = x.to(torch.uint8)
    return (x[..., 1::2] << 4) | x[..., 0::2]


def unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)


def nearest_level_idx(y: torch.Tensor, levels_sorted: torch.Tensor) -> torch.Tensor:
    """Index of the nearest entry of a sorted level set (last axis), per
    scalar; exact midpoints round to the upper level.  Leading axes of
    ``levels_sorted`` pair with those of ``y`` (one level set per row)."""
    thr = 0.5 * (levels_sorted[..., 1:] + levels_sorted[..., :-1])
    return torch.searchsorted(thr.contiguous(), y.contiguous(), right=True)


def block_sq_err(d: torch.Tensor) -> torch.Tensor:
    """Σ d² over the last axis, summed left to right (fixed order)."""
    sq = d * d
    err = sq[..., 0]
    for i in range(1, sq.shape[-1]):
        err = err + sq[..., i]
    return err


# -------------------------------------------------------------- encode path
def codeword_over(amax: torch.Tensor, cfg: BCQConfig) -> torch.Tensor:
    """(2^(B_c-1)-1) / amax as an IEEE division (``scalar / tensor`` in
    torch is reciprocal-then-multiply, which rounds differently)."""
    return torch.full_like(amax, cfg.codeword_max) / amax


def tensor_scale(x: torch.Tensor, cfg: BCQConfig) -> torch.Tensor:
    amax = x.float().abs().amax()
    return torch.where(amax > 0, codeword_over(amax, cfg), torch.ones_like(amax))


def _array_scales(arrays: torch.Tensor, cfg: BCQConfig, s_x: torch.Tensor):
    """ŝ_A (E4M3-snapped) and the total scale ŝ_A·s_X per array."""
    amax = arrays.abs().amax(dim=-1)
    s_a = torch.where(amax > 0, codeword_over(amax, cfg), s_x)
    ratio = formats.E4M3.quantize(s_a / s_x)
    ratio = torch.clamp_min(ratio, formats.E4M3.min_subnormal)
    return ratio, ratio * s_x


def _select_and_index(blocks: torch.Tensor, codebooks: torch.Tensor):
    """Per-block codebook selector + per-scalar nearest-entry index.

    blocks: (..., L_b) normalized values; codebooks: (N_c, 2^B) sorted.
    All codebooks are tried at once (a few launches instead of a loop per
    codebook); ``argmin`` takes the first minimum, like the reference and
    like the strict-< running argmin of the CUDA encode.
    Returns (sel int64 (...,), idx int64 (..., L_b))."""
    nc = codebooks.shape[0]
    flat = blocks.reshape(1, -1).expand(nc, -1)
    idx = nearest_level_idx(flat, codebooks)  # (N_c, numel)
    q = torch.gather(codebooks, 1, idx)
    idx = idx.reshape((nc,) + blocks.shape)
    err = block_sq_err((flat - q).reshape((nc,) + blocks.shape))  # (N_c, ...)
    sel = torch.argmin(err, dim=0)
    best = torch.gather(idx, 0, sel[None, ..., None].expand((1,) + blocks.shape))[0]
    return sel, best


def _normalized_blocks(x: torch.Tensor, codebooks, cfg: BCQConfig, s_x):
    """Shared front half of encode/fake-quant: pad, per-array scales,
    block selection.  Returns (lead, na, ratio, scale, sel, idx)."""
    xp, _ = pad_to_multiple(x, cfg.array_len)
    lead = xp.shape[:-1]
    na = xp.shape[-1] // cfg.array_len
    arrays = xp.reshape(*lead, na, cfg.array_len)
    ratio, scale = _array_scales(arrays, cfg, s_x)
    y = arrays * scale[..., None]
    blocks = y.reshape(*lead, na, cfg.blocks_per_array, cfg.block_len)
    sel, idx = _select_and_index(blocks, codebooks)
    return lead, na, ratio, scale, sel, idx


def encode(x: torch.Tensor, codebooks: torch.Tensor, cfg: BCQConfig, s_x=None) -> Encoded:
    """Encode ``x`` (blocks along the last axis) to packed LO-BCQ."""
    xf = x.float()
    if s_x is None:
        s_x = tensor_scale(xf, cfg)
    lead, na, ratio, _, sel, idx = _normalized_blocks(xf, codebooks, cfg, s_x)
    idx_flat = idx.reshape(*lead, na * cfg.array_len)
    sel_flat, _ = pad_to_multiple(sel.reshape(*lead, na * cfg.blocks_per_array), 2)
    return Encoded(
        packed_idx=pack_nibbles(idx_flat),
        packed_sel=pack_nibbles(sel_flat),
        scale_code=formats.e4m3_to_bits(ratio),
        s_x=torch.as_tensor(s_x, dtype=torch.float32),
    )


def decode(enc: Encoded, codebooks: torch.Tensor, cfg: BCQConfig, out_len: int) -> torch.Tensor:
    """Inverse of :func:`encode`; ``out_len`` is the unpadded last-dim size."""
    idx = unpack_nibbles(enc.packed_idx).long()
    lead = idx.shape[:-1]
    kp = idx.shape[-1]
    na = kp // cfg.array_len
    sel = unpack_nibbles(enc.packed_sel).long()[..., : na * cfg.blocks_per_array]
    scale = formats.bits_to_e4m3(enc.scale_code) * enc.s_x  # (..., na)
    sel_per_scalar = torch.repeat_interleave(sel, cfg.block_len, dim=-1)
    vals = codebooks.reshape(-1)[sel_per_scalar * cfg.n_entries + idx]
    vals = vals.reshape(*lead, na, cfg.array_len) / scale[..., None]
    return vals.reshape(*lead, kp)[..., :out_len]


def fake_quant(x: torch.Tensor, codebooks: torch.Tensor, cfg: BCQConfig, s_x=None) -> torch.Tensor:
    """Quantize-dequantize in one shot (bit-identical to decode∘encode).

    A CUDA tensor is encoded by the quantize kernel (B3,
    ``kernels.bcq_quantize``, x as (M, K) padded to whole arrays; ``s_x``
    a 0-d tensor) and decoded with torch ops on the device; a CPU tensor
    takes ``fake_quant_plain``.  The decoded values are the plain
    route's, bit for bit (a codebook tie moves a selector, not a value)."""
    if x.device.type == "cpu":
        return fake_quant_plain(x, codebooks, cfg, s_x)
    from repro_torch.kernels.bcq_quantize import bcq_quantize

    xf = x.float()
    if s_x is None:
        s_x = tensor_scale(xf, cfg)
    k = xf.shape[-1]
    x2, _ = pad_to_multiple(xf.reshape(-1, k), cfg.array_len)
    idx, sel, ratio = bcq_quantize(x2.contiguous(), codebooks, s_x, cfg)
    out = dequantize(idx, sel, ratio * s_x, codebooks, cfg)
    return out[:, :k].reshape(x.shape).to(x.dtype)


def dequantize(packed_idx, packed_sel, scale, codebooks, cfg: BCQConfig) -> torch.Tensor:
    """Values of a packed encoding: C_sel[idx] / (ŝ_A·s_X), ``scale`` the
    (..., n_arrays) products ŝ_A·s_X → (..., n_arrays·L_A) f32."""
    idx = unpack_nibbles(packed_idx).long()
    lead, kp = idx.shape[:-1], idx.shape[-1]
    na = kp // cfg.array_len
    sel = unpack_nibbles(packed_sel).long()[..., : na * cfg.blocks_per_array]
    vals = codebooks.reshape(-1)[torch.repeat_interleave(sel, cfg.block_len, -1) * cfg.n_entries
                                 + idx]
    return (vals.reshape(*lead, na, cfg.array_len) / scale[..., None]).reshape(*lead, kp)


def fake_quant_plain(x: torch.Tensor, codebooks: torch.Tensor, cfg: BCQConfig,
                     s_x=None) -> torch.Tensor:
    """``fake_quant`` through the plain encode on any device (the
    reference's ``bcq.fake_quant``)."""
    dt = x.dtype
    xf = x.float()
    if s_x is None:
        s_x = tensor_scale(xf, cfg)
    lead, na, _, scale, sel, idx = _normalized_blocks(xf, codebooks, cfg, s_x)
    vals = codebooks.reshape(-1)[sel[..., None] * cfg.n_entries + idx]
    out = (vals.reshape(*lead, na, cfg.array_len) / scale[..., None]).reshape(
        *lead, na * cfg.array_len
    )
    return out[..., : x.shape[-1]].to(dt)


# --------------------------------------------------------- encode statistics
def encode_stats(x: torch.Tensor, codebooks: torch.Tensor, cfg: BCQConfig, s_x=None):
    """Online quantization-error stats of encoding ``x`` (the quant-error
    probe, ``serving.telemetry.QuantProbeRecorder``): the NMSE of the
    quantize-dequantize round trip and the per-codebook selector occupancy
    (how often each cluster wins the per-block argmin of Eq. 4).  Returns
    (nmse f32 0-d, occupancy (N_c,) int64), on x's device.  Padding to a
    whole array is excluded from the NMSE, but its (all-zero) blocks count
    toward the occupancy, as in the stored encoding.

    A CUDA tensor is encoded by the quantize kernel
    (``kernels.bcq_quantize``, x as (M, K)), then decoded and reduced with
    torch ops on the device, without a host sync (so a CUDA graph can
    capture it); a CPU tensor takes ``encode_stats_plain``."""
    if x.device.type == "cpu":
        return encode_stats_plain(x, codebooks, cfg, s_x)
    from repro_torch.kernels.bcq_quantize import bcq_quantize

    xf = x.float()
    if s_x is None:
        s_x = tensor_scale(xf, cfg)
    x2, _ = pad_to_multiple(xf.reshape(-1, xf.shape[-1]), cfg.array_len)
    idx, sel, ratio = bcq_quantize(x2.contiguous(), codebooks, s_x, cfg)
    return _stats(xf, idx, sel, ratio, s_x, codebooks, cfg)


def encode_stats_plain(x: torch.Tensor, codebooks: torch.Tensor, cfg: BCQConfig, s_x=None):
    """``encode_stats`` through ``encode`` on any device (the reference's
    ``bcq.encode_stats``)."""
    xf = x.float()
    if s_x is None:
        s_x = tensor_scale(xf, cfg)
    enc = encode(xf, codebooks, cfg, s_x)
    return _stats(xf, enc.packed_idx, enc.packed_sel, formats.bits_to_e4m3(enc.scale_code),
                  s_x, codebooks, cfg)


def _stats(xf, packed_idx, packed_sel, ratio, s_x, codebooks, cfg: BCQConfig):
    """NMSE and selector occupancy of an encoding of ``xf`` (packed idx and
    sel of its padded arrays, their E4M3 ratios)."""
    xq = dequantize(packed_idx, packed_sel, ratio * s_x, codebooks, cfg)[..., : xf.shape[-1]]
    na = packed_idx.shape[-1] * 2 // cfg.array_len
    sel = unpack_nibbles(packed_sel).long()[..., : na * cfg.blocks_per_array]
    occupancy = torch.zeros((cfg.n_codebooks,), dtype=torch.int64, device=xf.device)
    occupancy.index_add_(0, sel.reshape(-1), torch.ones_like(sel.reshape(-1)))
    return quantization_nmse(xf, xq.reshape(xf.shape)), occupancy


def quantization_nmse(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Σ(x − x̂)² / max(Σx², 1e-12) in f32."""
    x = x.float()
    d = x - xq.float()
    return torch.sum(d * d) / torch.clamp_min(torch.sum(x * x), 1e-12)


# ----------------------------------------------------------- LO-BCQ fitting
def calib_blocks(t, cfg: BCQConfig) -> torch.Tensor:
    """A calibration tensor as per-array-normalized blocks (N_b, L_b): the
    flattened tensor truncated to whole arrays (nothing padded), s_X over
    all of it (the reference's calibration ``_normalized_blocks``)."""
    xf = torch.as_tensor(t).reshape(-1).float()
    n = (xf.shape[0] // cfg.array_len) * cfg.array_len
    arrays = xf[:n].reshape(-1, cfg.array_len)
    _, scale = _array_scales(arrays, cfg, tensor_scale(xf, cfg))
    return (arrays * scale[:, None]).reshape(-1, cfg.block_len)


def _assign_mse(blocks: torch.Tensor, codebooks: torch.Tensor):
    """Cluster assignment (Eq. 4) and the resulting per-block squared
    error: (assign (N_b,) int64, err (N_b,))."""
    lv = torch.sort(codebooks.float(), dim=-1).values
    nc = lv.shape[0]
    flat = blocks.reshape(1, -1).expand(nc, -1)
    q = torch.gather(lv, 1, nearest_level_idx(flat, lv))
    errs = block_sq_err((flat - q).reshape((nc,) + blocks.shape))  # (N_c, N_b)
    return torch.argmin(errs, dim=0), torch.amin(errs, dim=0)


def _calib_setup(tensors, cfg: BCQConfig, key):
    """The calibration blocks of ``tensors``, concatenated in the order
    given on the first tensor's device, and the fit's key there (default
    ``prng_key(0)``)."""
    if isinstance(tensors, (torch.Tensor, np.ndarray)):
        tensors = [tensors]
    tensors = [torch.as_tensor(t) for t in tensors]
    blocks = torch.cat([calib_blocks(t.to(tensors[0].device), cfg) for t in tensors])
    return blocks, (prng.prng_key(0) if key is None else key).to(blocks.device)


def _fit_loop(blocks, levels, cfg: BCQConfig, iters, lm_iters, tol):
    """Alternate re-clustering (Eq. 4/5) and the warm-started Lloyd-Max
    refit (Eq. 6); ``tol`` None runs every iteration.  Returns (levels,
    history: the per-scalar MSE after each iteration)."""
    scalars = blocks.reshape(-1)
    history, prev = [], float("inf")
    for _ in range(iters):
        assign, _ = _assign_mse(blocks, levels)
        levels = lloyd_max_batched(scalars, torch.repeat_interleave(assign, cfg.block_len),
                                   levels, iters=lm_iters)
        _, errs2 = _assign_mse(blocks, levels)
        j = float(errs2.mean() / cfg.block_len)
        history.append(j)
        if tol is not None and prev - j < tol * max(prev, 1e-12):
            break
        prev = j
    return levels, history


def fit_lobcq(tensors: Sequence | torch.Tensor, cfg: BCQConfig, key: torch.Tensor | None = None,
              iters: int = 30, lm_iters: int = 25, max_blocks: int = 65536, tol: float = 1e-7,
              quantize_codewords: bool = True) -> CodebookSet:
    """Calibrate N_c codebooks with the LO-BCQ alternating algorithm (§2.2)
    on the first tensor's device.

    ``tensors`` — calibration operands (weights and/or captured
    activations), concatenated as blocks in the order given; ``key`` — a
    ``jax.random`` key as ``serving.prng`` holds it (default
    ``prng_key(0)``): the ``max_blocks`` subsample and the k-means++
    seeds draw what the reference draws with the same key.  Returns a
    :class:`CodebookSet` whose ``history`` is the per-iteration MSE, non-
    increasing (§A.2)."""
    blocks, key = _calib_setup(tensors, cfg, key)
    if blocks.shape[0] > max_blocks:
        key, kp = split(key)
        blocks = blocks[permutation(kp, blocks.shape[0])[:max_blocks]]

    # init: k-means++ seeds over blocks, per-cluster quantile levels
    key, ks = split(key)
    seeds = kmeanspp_seeds(blocks, cfg.n_codebooks, ks)
    assign = torch.argmin(block_sq_err(blocks[:, None, :] - seeds[None, :, :]), dim=1)
    glob = quantile_init(blocks.reshape(-1), cfg.n_entries)
    levels = lloyd_max_batched(blocks.reshape(-1), torch.repeat_interleave(assign, cfg.block_len),
                               glob[None, :].repeat(cfg.n_codebooks, 1), iters=lm_iters)
    levels, history = _fit_loop(blocks, levels, cfg, iters, lm_iters, tol)
    if quantize_codewords:
        levels = torch.clamp(torch.round(levels), -cfg.codeword_max, cfg.codeword_max)
    levels = torch.sort(levels, dim=-1).values
    return CodebookSet(levels=levels.cpu().numpy(), cfg=cfg, history=history)


def naive_init_fit(tensors, cfg: BCQConfig, key: torch.Tensor | None = None,
                   **kw) -> CodebookSet:
    """Ablation baseline: uniform random codebook init instead of k-means++
    (Fig. 4); every iteration runs, and the codewords are rounded."""
    blocks, key = _calib_setup(tensors, cfg, key)
    levels = uniform(key, cfg.n_codebooks * cfg.n_entries, -cfg.codeword_max,
                     cfg.codeword_max).reshape(cfg.n_codebooks, cfg.n_entries)
    levels, history = _fit_loop(blocks, levels, cfg, kw.get("iters", 30), kw.get("lm_iters", 25),
                                None)
    levels = torch.clamp(torch.round(levels), -cfg.codeword_max, cfg.codeword_max)
    return CodebookSet(torch.sort(levels, dim=-1).values.cpu().numpy(), cfg, history)
