"""Port parity of the bcq4 KV-page writer's arithmetic, on the CPU.

The page-store form of csrc/bcq_quantize.cu cannot run here, so this
file emulates what it does in torch and holds the emulation — and the
port's plain writer — to the JAX package's ``paged_token_write`` and
``paged_chunk_write`` (repro/models/layers.py), which encode with the
jnp ``bcq.encode``:

* the banked value table (codebooks 0–3 and 4–7 per row v = clamp(
  floor(2y), −64, 63) + 64, eight copies, lane l reading copy l & 7), the
  error of all 8 codebooks per scalar summed left to right over the
  block, a strict-< running argmin, the winner's index from the entry
  table;
* E4M3 with the exponent taken from the f32 bits (not floor(log2)) and
  the stored scale code taken from the snapped ratio's bits;
* where the writer stores: decode rows to (page, slot), a slot shared by
  several rows written by the last of them only; chunk rows to their
  pages from slot 0, zeros past C and past chunk_len, a page named twice
  written by its last (b, j) in row-major order.

Bytes must be equal; the one allowed difference, a codebook tie, cannot
occur here (the same f32 errors in the same order on both sides).
Inputs are made with numpy from fixed seeds.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the parity side; absent where only the port runs

from repro.core import formats as jfmt
from repro.core.bcq import BCQConfig as JCfg
from repro.core.calibrate import default_universal_codebooks
from repro.kernels import common as jcommon
from repro.models import layers as jlayers
from repro_torch.core import bcq as tbcq
from repro_torch.core import formats as tfmt
from repro_torch.models import layers as tlayers
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

JC, TC = JCfg(), tbcq.BCQConfig()
CB = np.asarray(default_universal_codebooks(JC).levels, dtype=np.float32)
LB, NC, COPIES = 8, 8, 8
LEAVES = ("idx", "sel", "scale")


# ------------------------------------------------------------- emulation
def e4m3_snap_bits(a: torch.Tensor) -> torch.Tensor:
    """The kernel's E4M3 snap: the exponent from a's f32 exponent field."""
    biased = (torch.clamp_min(a, 1e-38).view(torch.int32) >> 23) & 0xFF
    e = (biased - 127).clamp(-6, 8)
    q = torch.round(a * tfmt.pow2(3 - e)) * tfmt.pow2(e - 3)
    return q.clamp_max(448.0).clamp_min(2.0**-9)


def e4m3_code(r: torch.Tensor) -> torch.Tensor:
    """The kernel's scale code of an E4M3-grid ratio: exponent and top 3
    mantissa bits of its f32 bits, r · 2^9 below 2^-6."""
    b = r.view(torch.int32)
    e = (b >> 23) - 127
    normal = ((e + 7) << 3) | ((b >> 20) & 7)
    return torch.where(e < -6, torch.round(r * 512).to(torch.int32), normal).to(torch.uint8)


def banked_tables(cb: torch.Tensor):
    """The kernel's shared-memory tables: val_lo / val_hi (128·COPIES, 4)
    f32 rows, copy j of row v at v·COPIES + j, and the entry index (N_c,
    128) of each codebook per row."""
    v = torch.arange(-64, 64, dtype=torch.float32)
    k = ((cb[:, 1:] + cb[:, :-1])[:, None, :] <= v[None, :, None]).sum(-1)  # (N_c, 128)
    val = torch.gather(cb, 1, k).T  # (128, N_c)
    rows = val.repeat_interleave(COPIES, dim=0)  # row v, copy j at v·COPIES + j
    return rows[:, :4].contiguous(), rows[:, 4:].contiguous(), k


def encode_vectors(x: torch.Tensor, s_x: torch.Tensor, la: int, cb: torch.Tensor, first_g: int):
    """Encode head vectors x (N, D) f32 with per-vector s_x (N,) as the
    kernel does; block n of the flattened (N, D/8) blocks is thread
    g = first_g + n.  Returns (idx (N, D) int64, sel (N, D/8), ratio
    (N, D/la))."""
    n, d = x.shape
    lo, hi, ent_k = banked_tables(cb)
    arrays = x.reshape(n, d // la, la)
    amax = arrays.abs().amax(-1)
    s_a = torch.where(amax > 0, tbcq.codeword_over(amax, TC), s_x[:, None])
    ratio = e4m3_snap_bits(s_a / s_x[:, None])
    y = (arrays * (ratio * s_x[:, None])[..., None]).reshape(n, d // LB, LB)
    row = (torch.clamp(torch.floor(torch.nan_to_num(y + y, nan=-64.0)), -64, 63) + 64).long()
    copy = (first_g + torch.arange(n * (d // LB)).reshape(n, d // LB)) % COPIES
    at = row * COPIES + copy[..., None]
    w = torch.cat([lo[at], hi[at]], dim=-1)  # (N, D/8, 8 scalars, N_c)
    dif = y[..., None] - w
    sq = dif * dif
    err = sq[..., 0, :]
    for i in range(1, LB):  # left to right over the block
        err = err + sq[..., i, :]
    best = torch.full(err.shape[:-1], float("inf"))
    sel = torch.zeros(err.shape[:-1], dtype=torch.int64)
    for c in range(NC):  # strict-< running argmin
        take = err[..., c] < best
        best = torch.where(take, err[..., c], best)
        sel = torch.where(take, c, sel)
    idx = ent_k[sel[..., None].expand_as(row), row]
    return idx.reshape(n, d), sel, ratio


def emulated_page_write(pool, k, v, cb, la, *, page_ids=None, offsets=None,
                        chunk_page_ids=None, chunk_len=None):
    """The page-store kernel's effect on a single-layer bcq4 pool, in place."""
    b, s, h, d = k.shape
    ps = pool["k_idx"].shape[1]
    if chunk_page_ids is None:
        rows = [(bi, 0, int(page_ids[bi]), int(offsets[bi])) for bi in range(b)
                if not any((int(page_ids[b2]), int(offsets[b2])) == (int(page_ids[bi]), int(offsets[bi]))
                           for b2 in range(bi + 1, b))]
    else:
        n_cp = chunk_page_ids.shape[1]
        flat = chunk_page_ids.reshape(-1).tolist()
        rows = [(f // n_cp, (f % n_cp) * ps + slot, flat[f], slot)
                for f in range(len(flat)) if flat[f] not in flat[f + 1:] for slot in range(ps)]
    for side, (nm, val) in enumerate((("k", k), ("v", v))):
        sx = pool[f"{nm}_sx"]
        for bi, t, page, slot in rows:
            valid = t < s and (chunk_len is None or t < int(chunk_len[bi]))
            if not valid:
                for part in LEAVES:
                    pool[f"{nm}_{part}"][page, slot] = 0
                continue
            # thread of block 0 of this (side, row, head 0) vector; the copy index is g % 8
            n_rows = b if chunk_page_ids is None else b * chunk_page_ids.shape[1] * ps
            r = bi if chunk_page_ids is None else (bi * chunk_page_ids.shape[1] + t // ps) * ps + slot
            g0 = ((side * n_rows + r) * h) * (d // LB)
            x = val[bi, t].float()
            idx, sel, ratio = encode_vectors(x, sx.expand(h), la, cb, g0)
            pool[f"{nm}_idx"][page, slot] = tbcq.pack_nibbles(idx)
            pool[f"{nm}_sel"][page, slot] = tbcq.pack_nibbles(sel)
            pool[f"{nm}_scale"][page, slot] = e4m3_code(ratio)
    return pool


# ----------------------------------------------------------------- cases
def _la(d):
    return 64 if d % 64 == 0 else min(64, d)


def _midpoint_vector(d, rng):
    """31 (so s_a = 1 and, with s_x = 1, y = x) then codebook thresholds:
    every scalar sits exactly on a midpoint between two codewords."""
    thr = (0.5 * (CB[:, 1:] + CB[:, :-1])).ravel()
    x = rng.choice(thr, d).astype(np.float32)
    x[0] = 31.0
    return x


def _kv(b, s, h, d, seed):
    """Seeded K/V with the special vectors: an all-zero head, heads of
    codeword midpoints (K side, where s_x = 1), an outlier head."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((b, s, h, d)) * 1.5).astype(np.float32)
    v = rng.standard_t(3.0, (b, s, h, d)).astype(np.float32)
    k[0, :, 0] = 0.0
    v[-1, :, -1] = 0.0
    for t in range(s):
        k[min(1, b - 1), t, h - 1] = _midpoint_vector(d, rng)
    k[-1, 0, 0, 3] *= 40.0
    return k, v


def _pools(d, n_pages, ps, h, seed):
    """The same single-layer bcq4 pool for JAX and the port, its page
    bytes random (so every write shows), k_sx = 1 and v_sx = 0.37."""
    rng = np.random.default_rng(seed)
    jpool = dict(jlayers.cache_init(n_pages, ps, h, d, "bcq4", JC))
    for n, leaf in list(jpool.items()):
        if leaf.ndim >= 2:
            jpool[n] = jnp.asarray(rng.integers(0, 256, leaf.shape, dtype=np.uint8))
    jpool["v_sx"] = jnp.float32(0.37)
    tpool = {n: torch.from_numpy(np.array(a)) for n, a in jpool.items()}
    return jpool, tpool


def _as(dtype, x):
    """x in the test's K/V dtype, for both packages (bf16: one RNE rounding)."""
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _assert_pools_equal(jpool, *tpools):
    for n, leaf in jpool.items():
        for tp in tpools:
            np.testing.assert_array_equal(tp[n].numpy(), np.asarray(leaf), err_msg=n)


def _copy(pool):
    return {n: t.clone() for n, t in pool.items()}


D_HEADS = [16, 32, 64, 128]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", D_HEADS)
def test_decode_write_matches_reference(d, dtype):
    """8 rows: 5 at their own slots (two on one page), 3 idle rows on the
    null page's slot 0 holding different tokens — the last must win."""
    h, ps, n_pages = 2, 8, 7
    jpool, tpool = _pools(d, n_pages, ps, h, d)
    k, v = _kv(8, 1, h, d, d + 1)
    page_ids = np.array([3, 1, 3, 0, 5, 0, 6, 0], np.int32)
    offsets = np.array([2, 7, 5, 0, 0, 0, 3, 0], np.int32)
    (jk, tk), (jv, tv) = _as(dtype, k), _as(dtype, v)
    want = jlayers.paged_token_write(jpool, jk, jv, jnp.asarray(page_ids), jnp.asarray(offsets),
                                     "bcq4", JC, jnp.asarray(CB))
    plain = tlayers.paged_token_write(_copy(tpool), tk, tv, torch.from_numpy(page_ids),
                                      torch.from_numpy(offsets), "bcq4", TC, torch.from_numpy(CB))
    emu = emulated_page_write(_copy(tpool), tk, tv, torch.from_numpy(CB), _la(d),
                              page_ids=torch.from_numpy(page_ids),
                              offsets=torch.from_numpy(offsets))
    _assert_pools_equal(want, plain, emu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", D_HEADS)
def test_chunk_write_matches_reference(d, dtype):
    """4 rows of a C = 20 bucket over 3 pages of 8: a full row, a ragged
    last chunk (13 tokens), a row whose third page lies wholly past its
    chunk (9 tokens, that page routed to the null page) and a pad row (0
    tokens, every page on the null page) — the null page is named four
    times and written by its last (b, j)."""
    h, ps, n_pages, c = 2, 8, 11, 20
    jpool, tpool = _pools(d, n_pages, ps, h, d + 2)
    k, v = _kv(4, c, h, d, d + 3)
    ids = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 0], [0, 0, 0]], np.int32)
    chunk_len = np.array([20, 13, 9, 0], np.int32)
    (jk, tk), (jv, tv) = _as(dtype, k), _as(dtype, v)
    want = jlayers.paged_chunk_write(jpool, jk, jv, jnp.asarray(ids), "bcq4", JC, jnp.asarray(CB),
                                     jnp.asarray(chunk_len))
    plain = tlayers.paged_chunk_write(_copy(tpool), tk, tv, torch.from_numpy(ids), "bcq4", TC,
                                      torch.from_numpy(CB), torch.from_numpy(chunk_len))
    emu = emulated_page_write(_copy(tpool), tk, tv, torch.from_numpy(CB), _la(d),
                              chunk_page_ids=torch.from_numpy(ids),
                              chunk_len=torch.from_numpy(chunk_len))
    _assert_pools_equal(want, plain, emu)


def test_chunk_write_without_chunk_len_zeroes_past_the_chunk():
    """No chunk_len: the slots of the last page past C hold zeros."""
    d, h, ps, n_pages, c = 64, 2, 8, 6, 11
    jpool, tpool = _pools(d, n_pages, ps, h, 5)
    k, v = _kv(2, c, h, d, 6)
    ids = np.array([[2, 4], [5, 1]], np.int32)
    want = jlayers.paged_chunk_write(jpool, jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids),
                                     "bcq4", JC, jnp.asarray(CB))
    emu = emulated_page_write(_copy(tpool), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(CB), _la(d), chunk_page_ids=torch.from_numpy(ids))
    _assert_pools_equal(want, emu)
    assert not emu["k_idx"][4, c - ps:].any() and not emu["v_scale"][1, c - ps:].any()


def test_e4m3_from_exponent_bits_matches_reference_snap():
    """The exponent field in place of floor(log2): equal snaps, also
    within a few ulps of every power of two in and around the E4M3 range,
    and equal scale codes from the snapped ratio's bits."""
    rng = np.random.default_rng(0)
    pw = np.float32(2.0) ** np.arange(-12, 12, dtype=np.float32)
    near, down, up = [pw], pw, pw
    for _ in range(4):
        down, up = np.nextafter(down, np.float32(0)), np.nextafter(up, np.float32(np.inf))
        near += [down, up]
    a = np.concatenate(near + [np.exp(rng.uniform(-9, 7, 20000)).astype(np.float32),
                               np.float32([0.0, 1e-40, 1e-38, 448.0, 464.0, 1e6, 3e38])])
    a = a.astype(np.float32)
    got = e4m3_snap_bits(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcommon.e4m3_snap(jnp.asarray(a))))
    want = tfmt.E4M3.quantize(torch.from_numpy(a)).clamp_min(tfmt.E4M3.min_subnormal)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(e4m3_code(got).numpy(), np.asarray(jfmt.e4m3_to_bits(jnp.asarray(got.numpy()))))


def test_banked_table_copies_hold_the_nearest_codewords():
    """Every copy of a row holds, per codebook, the nearest codeword of
    y for every y whose floor(2y) + 64 is that row."""
    cb = torch.from_numpy(CB)
    lo, hi, _ = banked_tables(cb)
    for row in (0, 17, 63, 64, 65, 100, 127):
        y = torch.tensor([(row - 64) / 2, (row - 64) / 2 + 0.25, (row - 64) / 2 + 0.49])
        for j in range(COPIES):
            w = torch.cat([lo[row * COPIES + j], hi[row * COPIES + j]])
            for c in range(NC):
                near = cb[c][tbcq.nearest_level_idx(y, cb[c])]
                assert torch.equal(w[c].expand(3), near), (row, j, c)
