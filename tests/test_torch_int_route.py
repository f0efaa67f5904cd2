"""Port parity of the W4A4 kernels' integer route, on the CPU.

The CUDA kernels (csrc/bcq_encode.cuh, csrc/bcq_gemm.cuh) cannot run
here, so this file emulates their arithmetic in torch and holds the
emulations to the JAX package:

* the encode's table index rule — idx_c(y) = LUT_c[clamp(floor(2y), −64,
  63) + 64], LUT_c[v] the number of thresholds with 2·thr ≤ v − 64 —
  gives every idx/sel byte of ``bcq.encode`` (the port's and the JAX
  package's) and ``nearest_level_idx``'s index: equality, no tolerance;
* the GEMM's arithmetic — an exact integer sum per 64-wide array, folded
  into f32 as acc = fma(float(isum), a_inv·w_inv, acc) in ascending array
  order (for M ≤ 16: eight partial sums over every 8th array, added in
  order) — agrees with the JAX fused linear (its Pallas kernel in
  interpret mode, as tests/test_fused_linear.py runs it, and its
  ``impl="ref"`` oracle) within ``rtol=1e-5, atol=1e-5·max|ref|``: the
  reference rounds each decoded value before an f32 dot.  The fma is
  taken in f64 and rounded to f32 (the f64 product is exact; the f64 sum
  may round twice, far inside the tolerance).  The two routes (encode +
  GEMM, and quantize + packed GEMM) emulate to the same bits;
* the codebook premise the integer route rests on: the kernels' entry
  (``bcq.check_kernel_codebooks``) refuses non-integer, unsorted or
  out-of-range levels; ``CodebookSet`` refuses unsorted ones at load and
  loads the others (a ``fit_lobcq(quantize_codewords=False)`` set, run in
  plain torch by the fake modes).

Inputs are made with numpy from fixed seeds.
"""
import json

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the parity side; absent where only the port runs

from repro.core import bcq as jbcq
from repro.core.calibrate import default_universal_codebooks
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.core import bcq as tbcq
from repro_torch.core import formats as tfmt
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import ops as tops
from repro_torch.models.convert import from_numpy_tree

JC, TC = jbcq.BCQConfig(), tbcq.BCQConfig()
CB = default_universal_codebooks(JC).levels
LA, LB, NC = 64, 8, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(kind, shape, seed=7):  # the sweep of tests/test_torch_numerics.py
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.standard_normal(shape)
    elif kind == "heavy":
        x = rng.standard_t(3.0, shape)
    else:  # outlier
        x = rng.standard_normal(shape)
        x = np.where(rng.random(shape) < 0.005, x * 40.0, x)
    return x.astype(np.float32)


# ---------------------------------------------------------- encode emulation
def lut_tables(cb: torch.Tensor) -> torch.Tensor:
    """(N_c, 128): the number of thresholds of each codebook with
    2·thr = c_t + c_{t+1} ≤ v, for v = −64 … 63."""
    v = torch.arange(-64, 64, dtype=torch.float32)
    two_thr = cb[:, 1:] + cb[:, :-1]
    return (two_thr[:, None, :] <= v[None, :, None]).sum(-1)


def table_index(y: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """(N_c, *y.shape) index of the nearest entry per codebook, by the
    table (fmaxf sends NaN to −64, as the kernel's clamp does)."""
    two_y = torch.nan_to_num(y + y, nan=-64.0)
    v = torch.clamp(torch.floor(two_y), -64, 63).long() + 64
    return lut[:, v]


def table_encode(x: torch.Tensor, cb: torch.Tensor, s_x: torch.Tensor):
    """The encode of csrc/bcq_encode.cuh: per-array E4M3 ratio, the table
    index per scalar and codebook, the block error summed left to right,
    a strict-< running argmin.  Returns (idx (M, K), sel (M, K/8), ratio
    (M, K/64))."""
    m, k = x.shape
    arrays = x.reshape(m, k // LA, LA)
    amax = arrays.abs().amax(dim=-1)
    s_a = torch.where(amax > 0, tbcq.codeword_over(amax, TC), s_x)
    ratio = tcommon.e4m3_snap(s_a / s_x)
    blocks = (arrays * (ratio * s_x)[..., None]).reshape(m, k // LB, LB)
    idx_all = table_index(blocks, lut_tables(cb))  # (N_c, M, K/8, 8)
    best = torch.full(blocks.shape[:-1], float("inf"))
    sel = torch.zeros(blocks.shape[:-1], dtype=torch.int64)
    idx = torch.zeros(blocks.shape, dtype=torch.int64)
    for c in range(NC):
        err = tbcq.block_sq_err(blocks - cb[c][idx_all[c]])
        take = err < best
        best = torch.where(take, err, best)
        sel = torch.where(take, c, sel)
        idx = torch.where(take[..., None], idx_all[c], idx)
    return idx.reshape(m, k), sel, ratio


def test_table_index_rule_matches_threshold_compares():
    cb = _t(CB)
    thr = 0.5 * (cb[:, 1:] + cb[:, :-1])
    rng = np.random.default_rng(0)
    base = np.concatenate([
        rng.standard_normal(4000) * 20, np.arange(-70, 70, 0.25), thr.numpy().ravel(),
        [0.0, -0.0, 1e30, -1e30, np.inf, -np.inf, 31.0, -31.0, 31.999, -32.0, 63.5, -64.5],
    ]).astype(np.float32)
    y = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                        np.nextafter(base, np.float32(-np.inf))]).astype(np.float32)
    got = table_index(_t(y), lut_tables(cb))
    # XLA's CPU backend flushes subnormals to zero (−1e-45 ≥ 0 there); torch,
    # the table and the CUDA encode (built without fast math) keep IEEE
    normal = (np.abs(y) >= np.finfo(np.float32).tiny) | (y == 0)
    for c in range(NC):
        want_t = tbcq.nearest_level_idx(_t(y), cb[c])
        want_j = np.asarray(jbcq.nearest_level_idx(jnp.asarray(y[normal]), jnp.asarray(CB[c])))
        np.testing.assert_array_equal(got[c].numpy(), want_t.numpy())
        np.testing.assert_array_equal(got[c].numpy()[normal], want_j)
    # NaN passes no threshold, as in the compare loop
    assert table_index(torch.tensor([float("nan")]), lut_tables(cb)).eq(0).all()


@pytest.mark.parametrize("kind", ["normal", "heavy", "outlier"])
def test_table_encode_bytes_match_encode(kind):
    x = _inputs(kind, (64, 512))
    cb = _t(CB)
    s_x = tbcq.tensor_scale(_t(x), TC)
    idx, sel, ratio = table_encode(_t(x), cb, s_x)
    idx_p, sel_p = tbcq.pack_nibbles(idx), tbcq.pack_nibbles(sel)
    et = tbcq.encode(_t(x), cb, TC)
    ej = jbcq.encode(jnp.asarray(x), jnp.asarray(CB), JC)
    for e in (et, ej):
        np.testing.assert_array_equal(idx_p.numpy(), np.asarray(e.packed_idx))
        np.testing.assert_array_equal(sel_p.numpy(), np.asarray(e.packed_sel))
        np.testing.assert_array_equal(tfmt.e4m3_to_bits(ratio).numpy(), np.asarray(e.scale_code))


# ------------------------------------------------------------ GEMM emulation
def _codes(idx, sel, cb):
    """Integer codewords cb[sel][idx] (R, K) from unpacked indices."""
    return cb[torch.repeat_interleave(sel, LB, dim=-1), idx].long()


def _unpack(idx_p, sel_p, k):
    return tbcq.unpack_nibbles(idx_p).long(), tbcq.unpack_nibbles(sel_p).long()[:, : k // LB]


def int_gemm(ca, a_inv, cw, w_inv):
    """The GEMM's arithmetic on integer codes ca (M, K), cw (N, K) and
    per-array scales (R, K/64), in the kernel's fold order."""
    m, k = ca.shape
    n, ka = cw.shape[0], k // LA
    isum = torch.einsum("mak,nak->mna", ca.reshape(m, ka, LA), cw.reshape(n, ka, LA))

    def fold(acc, kb):
        s = (a_inv[:, kb][:, None] * w_inv[:, kb][None, :]).double()  # f32 product, then exact
        return (acc.double() + isum[..., kb].double() * s).float()

    if m > 16:
        acc = torch.zeros((m, n), dtype=torch.float32)
        for kb in range(ka):
            acc = fold(acc, kb)
        return acc
    parts = []
    for w in range(8):  # the small-M kernel's warps take every 8th array
        acc = torch.zeros((m, n), dtype=torch.float32)
        for kb in range(w, ka, 8):
            acc = fold(acc, kb)
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def fused_linear_emulated(x, pk_t):
    """The fused linear's two launches: the table encode writes codes and
    a_inv = 1 / (ratio · s_x), then the GEMM against the packed weight."""
    k = x.shape[1]
    cb = _t(CB)
    s_x = tbcq.tensor_scale(x, TC)
    idx, sel, ratio = table_encode(x, cb, s_x)
    a_inv = torch.ones_like(ratio) / (ratio * s_x)
    w = tops.packed_operand(pk_t)
    cw = _codes(*_unpack(w.idx_packed, w.sel_packed, k), cb)
    return int_gemm(_codes(idx, sel, cb), a_inv, cw, w.inv_scale)


def _weight(n, k, seed):
    w = (np.random.default_rng(seed).standard_normal((k, n)) * k**-0.5).astype(np.float32)
    pk = jlayers.pack_weight(jnp.asarray(w), JC, jnp.asarray(CB))
    return {n_: np.asarray(v) for n_, v in pk.items()}


def _activation(m, k, seed):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    x[:, :: max(1, k // 8)] *= 12.0  # outlier channels
    return x


# M ≤ 16 takes the small-M kernel's fold order, the others the tiled one
@pytest.mark.parametrize("mkn", [(8, 128, 64), (16, 1024, 48), (37, 192, 100)])
def test_int_route_matches_reference_fused_linear(mkn):
    m, k, n = mkn
    x = _activation(m, k, m + k)
    pk = _weight(n, k, n)
    got = fused_linear_emulated(_t(x), from_numpy_tree(pk)).numpy()
    jw = jops.packed_operand({a: jnp.asarray(b) for a, b in pk.items()})
    for impl in ("pallas", "ref"):
        want = np.asarray(jops.w4a4_linear_fused(
            jnp.asarray(x), jw, jnp.asarray(CB), JC, impl=impl, tile_m=64, tile_n=64, tile_k=64))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_int_routes_emulate_to_the_same_bits():
    """quantize + packed GEMM (B3 → B4) against encode + code GEMM (B1)."""
    m, k, n = 37, 256, 24
    x = _t(_activation(m, k, 5))
    pk = from_numpy_tree(_weight(n, k, 6))
    cb = _t(CB)
    a = tops.quantize(x, cb, TC)  # the CPU branch: quantize_ref's bytes
    w = tops.packed_operand(pk)
    two_launch = int_gemm(_codes(*_unpack(a.idx_packed, a.sel_packed, k), cb), a.inv_scale,
                          _codes(*_unpack(w.idx_packed, w.sel_packed, k), cb), w.inv_scale)
    assert torch.equal(two_launch, fused_linear_emulated(x, pk))


# ---------------------------------------------------------- codebook premise
def _bad_levels(kind):
    lv = np.array(CB, dtype=np.float32)
    if kind == "non_integer":
        lv[3, 5] += 0.5
    elif kind == "unsorted":
        lv[2, [4, 5]] = lv[2, [5, 4]]
    else:  # beyond codeword_max (31 for INT6)
        lv[7, -1] = 32.0
    return lv


@pytest.mark.parametrize("kind", ["non_integer", "unsorted", "out_of_range"])
def test_codebook_premise_is_checked_at_load(kind, tmp_path):
    """Loading refuses unsorted levels and keeps the others; the premise
    the kernels check at their entry refuses all three, on the host copy
    of the codebook tensor they are given."""
    path = tmp_path / "cb.json"
    path.write_text(json.dumps({"levels": _bad_levels(kind).tolist(),
                                "cfg": {"block_len": 8, "array_len": 64, "n_codebooks": 8}}))
    if kind == "unsorted":
        with pytest.raises(ValueError, match="codebook levels must be sorted"):
            tbcq.CodebookSet.load(str(path))
        with pytest.raises(ValueError, match="codebook levels must be sorted"):
            tbcq.CodebookSet(levels=_bad_levels(kind), cfg=TC)
    else:
        cs = tbcq.CodebookSet.load(str(path))
        np.testing.assert_array_equal(cs.levels, _bad_levels(kind))
    with pytest.raises(ValueError, match="codebook levels"):
        tbcq.check_kernel_codebooks(torch.from_numpy(_bad_levels(kind)), TC)
    with pytest.raises(ValueError, match="codebook levels"):
        tbcq.check_codebook_levels(_bad_levels(kind), TC)


def test_committed_codebooks_meet_the_premise():
    cs = tbcq.CodebookSet(levels=np.array(CB, dtype=np.float32), cfg=TC)
    assert np.array_equal(cs.levels, np.round(cs.levels))
    assert np.abs(cs.levels).max() <= TC.codeword_max
    cb = cs.as_tensor()
    tbcq.check_kernel_codebooks(cb, TC)
    cb.mul_(0.5)  # a tensor that passed, edited in place, is checked again
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        tbcq.check_kernel_codebooks(cb, TC)
