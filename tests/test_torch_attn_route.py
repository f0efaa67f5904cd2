"""Port parity of the two attention kernels' arithmetic, on the CPU.

The CUDA kernels (csrc/flash_attention.cu, csrc/page_gather.cu) cannot
run here, so this file emulates their arithmetic in torch and holds the
emulations to the JAX package, whose Pallas kernels run in interpret
mode as its own tests run them:

* flash attention, bf16 inputs (``flash_bf16_mma_kernel``): 64 × 64
  tiles, causal tiles above the diagonal skipped, S from exact bf16
  products summed in f32, the online softmax in f32, P rounded to bf16
  for the P·V product while l sums the f32 p, out = acc / max(l, 1e-30)
  rounded to bf16.  Against ``flash_attention_pallas(interpret=True)`` on
  the same bf16 inputs within ``atol = rtol = 1e-2``: the bf16 tolerance
  of tests/test_torch_cuda.py and chip_smoke.py (the output's bf16
  rounding of two f32 sums taken in different orders).  Before the output
  rounding, the f32 results differ by at most ``2^-8 · max|v|``: rounding
  P to bf16 moves each weight by at most 2^-9 of itself, so the output by
  at most 2^-9 · max|v|, and twice that covers the sum orders.  At ragged
  S, which the reference wrapper cannot take, the emulation is held to a
  masked softmax in f64 numpy within the same bounds;
* page gather (``page_gather_split_kernel`` + ``page_gather_combine_kernel``):
  a row's walked pages cut into splits of ``split_pages``, warp w of a
  split taking pages w, w + 4, … with its own online softmax, the four
  warps' states merged in warp order, the splits' partials in ascending
  split order.  Against ``page_gather_attention(interpret=True)`` within
  ``atol = rtol = 2e-5`` (GATHER_TOL of chip_smoke.py, as
  tests/test_paged_kernel.py: softmax and accumulation order differ), for
  bcq4 and int8 pages, decode and chunks, several splits a row, lengths on
  and just past a split edge, a zero-length row and NULL padding.

Inputs are made with numpy from fixed seeds.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the parity side; absent where only the port runs

from repro.core.bcq import BCQConfig as JCfg
from repro.core.calibrate import default_universal_codebooks
from repro.kernels.common import page_gather_attention as j_page_gather
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as jlayers
from repro_torch.core import bcq as tbcq
from repro_torch.kernels import common as tcommon
from repro_torch.models.convert import from_numpy_tree

NEG = -1e30
TILE = 64  # flash: query rows and keys per tile
WARPS = 4  # page gather: warps per split block
JC, TC = JCfg(), tbcq.BCQConfig()
CB = default_universal_codebooks(JC).levels


# ----------------------------------------------------------------- flash
def flash_tiles_emulated(q, k, v, causal):
    """(BH, S, D) bf16 → (BH, S, D) f32 before the output's bf16 rounding,
    by the tile schedule and roundings of flash_bf16_mma_kernel."""
    bh, s_len, d = q.shape
    qf, kf, vf = (t.float() for t in (q, k, v))
    out = torch.empty((bh, s_len, d))
    for q0 in range(0, s_len, TILE):
        rows = torch.arange(q0, min(q0 + TILE, s_len))
        m = torch.full((bh, len(rows)), NEG)
        l = torch.zeros((bh, len(rows)))
        acc = torch.zeros((bh, len(rows), d))
        n_kt = -(-s_len // TILE)
        if causal:
            n_kt = min(n_kt, (q0 + TILE - 1) // TILE + 1)
        for kt in range(n_kt):
            cols = torch.arange(kt * TILE, min((kt + 1) * TILE, s_len))  # keys past S: p = 0
            s = (qf[:, rows] @ kf[:, cols].transpose(1, 2)) * d**-0.5
            if causal:
                s = torch.where(cols[None, None] <= rows[None, :, None], s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, cols]
            m = m_new
        out[:, rows] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out


def _bf16_qkv(bh, s_len, d, seed):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((bh, s_len, d)).astype(np.float32) for _ in range(3)]
    return [torch.from_numpy(a).to(torch.bfloat16) for a in qkv]


def _jax_flash(q, k, v, causal, out_dtype):
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(out_dtype) for t in (q, k, v))
    return np.asarray(flash_attention_pallas(jq, jk, jv, causal=causal, tq=TILE, tk=TILE,
                                             interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s_len,d", [(64, 64), (192, 32), (256, 128)])
def test_flash_bf16_p_tiles_match_reference(s_len, d, causal):
    q, k, v = _bf16_qkv(3, s_len, d, s_len + d)
    got = flash_tiles_emulated(q, k, v, causal)
    want = _jax_flash(q, k, v, causal, jnp.bfloat16)
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want, rtol=1e-2, atol=1e-2)
    # before the output rounding: the bf16 P's own error bound
    want32 = _jax_flash(q, k, v, causal, jnp.float32)
    bound = 2.0**-8 * float(v.float().abs().max())
    assert float(np.abs(got.numpy() - want32).max()) <= bound


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_p_tiles_at_ragged_length(causal):
    """S = 200: the last tile holds 8 keys and 8 query rows."""
    q, k, v = _bf16_qkv(2, 200, 64, 5)
    got = flash_tiles_emulated(q, k, v, causal)
    q64, k64, v64 = (t.double().numpy() for t in (q, k, v))
    s = np.einsum("bqd,bkd->bqk", q64, k64) / 8.0
    if causal:
        s = np.where(np.tril(np.ones((200, 200), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), v64)
    assert float(np.abs(got.double().numpy() - want).max()) <= 2.0**-8 * float(np.abs(v64).max())
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want, rtol=1e-2, atol=1e-2)


# ----------------------------------------------------------- page gather
P, PS, HKV, D, MAXP = 14, 8, 2, 32, 12


def split_kv_emulated(q, pool, bt, kv_len, kind, split_pages):
    """(B, C, H, D) → (B, C, H, D) f32 by the split schedule and merge
    orders of the CUDA page gather."""
    b, c, h, d = q.shape
    kl, vl = tcommon.page_pool_leaves(pool, kind)
    ps, hkv = kl[0].shape[1:3]
    maxp, rep = bt.shape[1], h // hkv
    cb = torch.from_numpy(np.array(CB))
    bt = bt.long()
    kf = tcommon.dequant_page(kind, [leaf[bt] for leaf in kl], TC, cb, pool.get("k_sx"))
    vf = tcommon.dequant_page(kind, [leaf[bt] for leaf in vl], TC, cb, pool.get("v_sx"))
    qg = q.float().reshape(b, c, hkv, rep, d)
    out = torch.empty((b, c, h, d))

    def merge(states):  # in list order: warps of a split, then splits
        mx = torch.stack([st[0] for st in states]).amax(0)
        lsum, acc = torch.zeros_like(mx), torch.zeros_like(states[0][2])
        for m, l, a in states:
            w = torch.exp(m - mx)
            lsum = lsum + l * w
            acc = acc + a * w[..., None]
        return mx, lsum, acc

    for row in range(b):
        n = int(kv_len[row])
        steps = min(max(-(-n // ps), 1), maxp)
        qpos = n - c + torch.arange(c)
        splits = []
        for s0 in range(0, steps, split_pages):
            warps = []
            for w in range(WARPS):
                m = torch.full((c, hkv, rep), NEG)
                l = torch.zeros((c, hkv, rep))
                acc = torch.zeros((c, hkv, rep, d))
                for j in range(s0 + w, min(s0 + split_pages, steps), WARPS):
                    sc = torch.einsum("cgrd,tgd->cgrt", qg[row], kf[row, j]) * d**-0.5
                    tok = j * ps + torch.arange(ps)
                    sc = torch.where(tok[None, None, None] <= qpos[:, None, None, None], sc, NEG)
                    m_new = torch.maximum(m, sc.amax(-1))
                    p = torch.exp(sc - m_new[..., None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum("cgrt,tgd->cgrd", p, vf[row, j])
                    m = m_new
                warps.append((m, l, acc))
            splits.append(merge(warps))
        _, lsum, acc = merge(splits)
        out[row] = (acc / torch.clamp_min(lsum, 1e-30)[..., None]).reshape(c, h, d)
    return out


def _gather_case(kind, c, seed):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((P, PS, HKV, D)).astype(np.float32) for _ in range(2))
    jpool = jlayers.cache_write(jlayers.cache_init(P, PS, HKV, D, kind, JC),
                                jnp.asarray(k), jnp.asarray(v), 0, kind, JC, jnp.asarray(CB))
    tpool = from_numpy_tree({n: np.asarray(a) for n, a in jpool.items()})
    # on and just past the edges of 2- and 8-page splits, mid-page, full
    lengths = np.int32([0, 2 * PS, 2 * PS + 3, 8 * PS, 8 * PS + 1, MAXP * PS - 5, MAXP * PS])
    if c > 1:
        lengths = np.maximum(lengths, c)
        lengths[0] = 0  # a zero-length row under a full chunk
    bt = rng.integers(1, P, (len(lengths), MAXP)).astype(np.int32)
    for r, n in enumerate(lengths):
        bt[r, -(-n // PS):] = 0  # NULL past the live pages
    q = rng.standard_normal((len(lengths), c, 4, D)).astype(np.float32)  # GQA: 2 heads a group
    return jpool, tpool, q, bt, lengths


@pytest.mark.parametrize("split_pages", [2, tcommon.SPLIT_PAGES])
@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("kind", ["bcq4", "int8"])
def test_split_kv_schedule_matches_reference(kind, c, split_pages):
    jpool, tpool, q, bt, lengths = _gather_case(kind, c, 11 + c)
    want = np.asarray(j_page_gather(jnp.asarray(q), jpool, jnp.asarray(bt), jnp.asarray(lengths),
                                    kind, JC, jnp.asarray(CB), interpret=True))
    got = split_kv_emulated(torch.from_numpy(q), tpool, torch.from_numpy(bt),
                            torch.from_numpy(lengths), kind, split_pages)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
