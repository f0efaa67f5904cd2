"""Query-chunked attention with bf16 scores (``Runtime.attn_chunk``,
``Runtime.attn_f32``) and K of any whole number of arrays in the W4A4
GEMMs, against the JAX package on the CPU.

* ``layers._attend_chunked`` against the reference's at chunks that
  divide Sq, chunks that do not (the reference halves them until they
  divide, the port runs a shorter last chunk: the same values), and Sq ≤
  chunk; causal and
  windowed masks, GQA, per-row ``kv_valid_len``.  f32 scores within 1e-6
  (the same f32 ops, matmul sums in another order); bf16 scores bit for
  bit on the same inputs (q and k round to bf16 alike, torch's bf16
  softmax computes in f32 and rounds once, as the reference's f32
  softmax then cast) — held within one bf16 ulp of max|out| (2^-8) all
  the same, since a product's f32 sum order may round a bf16 score the
  other way.
* The gpt3 smoke's ``loss_fn`` and gradient at ``attn_chunk=8``,
  ``attn_f32=False`` (4 chunks of its 32 tokens): the loss within rtol
  1e-5 (the dense test's) and each gradient leaf within 2e-2 · max|g|
  of the leaf (6.5e-3 at most when written): the backward's products
  run in bf16 in both packages but round in other places — torch's bf16
  softmax backward reads the bf16 p, the reference's VJP its f32 softmax
  — so a gradient parts by bf16 ulps (2^-8), not f32 ones.
* The port's CPU fused linear, expert-stacked linear and two-launch
  GEMM at K 112 and 80 with L_A 16 and K 96 with L_A 32 against
  ``repro/kernels/ops.py`` (``impl="ref"``) at rtol 1e-5, atol 1e-5 ·
  max|ref| (both decode bit-identically; only the f32 sum order over K
  differs).  The card's route pads such a K to whole 64-wide steps
  (``bcq_linear.pad_weight``): its extra arrays encode to finite scales
  and meet zero weight scales, so the GEMM's per-array fold adds exactly
  nothing — emulated here bit for bit.
* ``cuda`` tests hold B1, B1s and B4 at those K to their plain versions
  on the card (``rtol=1e-5, atol=1e-5·max|plain|``), B4 ≡ B1 and B1s ≡
  per-expert B1 bit for bit, one launch each; they skip without a card
  and need no JAX: ``PYTHONPATH=src:tests python -m pytest -m cuda
  tests/test_torch_attn_chunk.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.core import bcq as tbcq
from repro_torch.kernels import bcq_linear, bcq_matmul, build, ops
from repro_torch.kernels.ref import (fused_linear_experts_ref, fused_linear_ref, matmul_ref,
                                     quantize_ref)
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from torch_formats import fitted_levels, fmt, tag
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

# (K, format): K a whole number of arrays but not of 64-wide steps
ODD_K = [(112, fmt(2, 16, 2)), (80, fmt(2, 16, 2)), (96, fmt(4, 32, 4))]
ODD_IDS = [f"K{k}-{tag(c)}" for k, c in ODD_K]
_LEVELS = {}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
    import jax.numpy as jnp

    from repro.configs.base import get_smoke
    from repro.core import bcq
    from repro.kernels import ops as jops
    from repro.models import layers, zoo

    return SimpleNamespace(jax=jax, jnp=jnp, get_smoke=get_smoke, bcq=bcq, jops=jops,
                           layers=layers, zoo=zoo)


def _levels(cfg):
    """The format's integer codebooks, fitted once (float32 numpy)."""
    if tag(cfg) not in _LEVELS:
        data = np.random.default_rng(0).laplace(size=60000).astype(np.float32)
        _LEVELS[tag(cfg)] = np.asarray(fitted_levels(cfg, torch.from_numpy(data)), np.float32)
    return _LEVELS[tag(cfg)]


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[..., :: max(1, shape[-1] // 8)] *= 12.0  # outlier channels
    return x


def _jcfg(ref, cfg):
    return ref.bcq.BCQConfig(block_len=cfg.block_len, array_len=cfg.array_len,
                             n_codebooks=cfg.n_codebooks, index_bits=cfg.index_bits,
                             codeword_bits=cfg.codeword_bits)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


# ------------------------------------------------------------ attention
# (Sq, chunk): divides; does not divide (the reference halves 10 to 5 then
# 2, the port takes 10, 10, 4; and 7 to 3 against 7, 7, 7, 3); Sq ≤ chunk
# (one chunk)
CHUNKS = [(24, 8), (24, 10), (24, 7), (24, 64)]


@pytest.mark.parametrize("score_f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq, chunk", CHUNKS)
@pytest.mark.parametrize("masks", ["causal", "window", "bidirectional", "rows"])
def test_attend_chunked_matches_reference(ref, masks, sq, chunk, score_f32):
    """GQA (8 query heads over 2 kv heads) at every chunk rule and mask:
    causal, causal + window 5, bidirectional, and per-row kv_valid_len
    (30 keys, 17 of them valid in row 0 and 30 in row 1, each row's queries
    at the last positions before its length)."""
    rng = np.random.default_rng(sq + chunk)
    b, h, hkv, d = 2, 8, 2, 16
    sk = sq
    causal, window = masks != "bidirectional", 5 if masks == "window" else None
    pos = np.broadcast_to(np.arange(sq)[None], (b, sq)).astype(np.int32)
    valid = sk
    if masks == "rows":
        sk = 30
        valid = np.array([17, 30], np.int32).reshape(b, 1, 1, 1)
        pos = (valid.reshape(b, 1) - sq + np.arange(sq)[None]).clip(0).astype(np.int32)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(np.float32) for _ in range(2))
    jn = ref.jnp.asarray
    want = np.asarray(ref.layers._attend_chunked(
        jn(q), jn(k), jn(v), jn(pos), jn(valid) if masks == "rows" else valid, causal, window,
        chunk, False, score_f32))
    tv = torch.from_numpy(valid) if masks == "rows" else valid
    got = tlayers._attend_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(pos), tv, causal, window, chunk, score_f32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    atol = 1e-6 if score_f32 else 2.0**-8 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_chunking_moves_no_value():
    """The port's chunks against one chunk of all rows, f32: rows are
    independent (the products' sums may differ by an ulp)."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 32, 4, 16), generator=g) for _ in range(3))
    pos = torch.arange(32)[None].expand(2, 32)
    whole = tlayers._attend_chunked(q, k, v, pos, 32)
    for chunk in (1, 4, 8, 12, 31):
        part = tlayers._attend_chunked(q, k, v, pos, 32, chunk=chunk)
        torch.testing.assert_close(part, whole, rtol=0, atol=1e-6)


def test_runtime_knobs_have_the_reference_defaults(ref):
    jrt, trt = ref.layers.Runtime(), TRuntime()
    assert (trt.attn_chunk, trt.attn_f32) == (jrt.attn_chunk, jrt.attn_f32) == (1024, True)


@pytest.fixture(scope="module")
def gpt3(ref):
    """The gpt3 smoke at attn_chunk 8 with bf16 scores in both packages,
    the same weights (one ``jax.random`` draw) and tokens (numpy)."""
    cfg = ref.get_smoke("gpt3_126m")
    jrt = ref.layers.Runtime(compute_dtype=ref.jnp.float32, param_dtype=ref.jnp.float32,
                             attn_chunk=8, attn_f32=False)
    api = ref.zoo.build(cfg, jrt)
    params = api.init(ref.jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    tapi = tzoo.build(t_get_smoke("gpt3_126m"), TRuntime(compute_dtype=torch.float32,
                                                         attn_chunk=8, attn_f32=False),
                      device="cpu")
    return SimpleNamespace(
        api=api, params=params, tapi=tapi,
        tparams=from_numpy_tree(ref.jax.tree.map(np.asarray, params)),
        jb={"tokens": ref.jnp.asarray(toks[:, :-1]), "labels": ref.jnp.asarray(toks[:, 1:])},
        tb={"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])})


def test_loss_and_gradient_with_bf16_scores_match_reference(ref, gpt3):
    loss, grads = ref.jax.jit(ref.jax.value_and_grad(gpt3.api.loss_fn))(gpt3.params, gpt3.jb)
    tloss, tgrads = ttrain.value_and_grad(gpt3.tapi.loss_fn, gpt3.tparams, gpt3.tb)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    flat = ref.jax.tree_util.tree_flatten_with_path(grads)[0]
    for path, want in flat:
        got = tgrads
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2 * np.abs(want).max(),
                                   err_msg=str(path))


def test_bf16_scores_change_the_loss_but_not_by_much(gpt3):
    """The same smoke with f32 scores: the bf16 path is a different
    computation (the loss moves) whose loss stays within 1e-2 of it."""
    f32 = tzoo.build(t_get_smoke("gpt3_126m"), TRuntime(compute_dtype=torch.float32,
                                                        attn_chunk=8), device="cpu")
    with torch.no_grad():
        a = float(f32.loss_fn(gpt3.tparams, gpt3.tb))
        b = float(gpt3.tapi.loss_fn(gpt3.tparams, gpt3.tb))
    assert a != b and abs(a - b) < 1e-2 * abs(a)


# --------------------------------------------------- K of whole arrays
def _packed_pair(ref, w, cfg, cb):
    """A (K, N) float weight packed by the reference's ``pack_weight``:
    (the reference's operand, the port's)."""
    pk = ref.layers.pack_weight(ref.jnp.asarray(w), _jcfg(ref, cfg), ref.jnp.asarray(cb))
    pk = {n: np.asarray(v) for n, v in pk.items()}
    return (ref.jops.packed_operand({a: ref.jnp.asarray(b) for a, b in pk.items()}),
            ops.packed_operand(from_numpy_tree(pk)))


@pytest.mark.parametrize("k, cfg", ODD_K, ids=ODD_IDS)
def test_fused_linear_at_odd_k_matches_reference(ref, k, cfg):
    cb = _levels(cfg)
    x = _x((2, 9, k), k)  # leading axes flatten into M
    w = (np.random.default_rng(k + 1).standard_normal((k, 40)) * k**-0.5).astype(np.float32)
    jw, tw = _packed_pair(ref, w, cfg, cb)
    want = ref.jops.w4a4_linear_fused(ref.jnp.asarray(x), jw, ref.jnp.asarray(cb),
                                      _jcfg(ref, cfg), impl="ref")
    got = ops.w4a4_linear_fused(torch.from_numpy(x), tw, torch.from_numpy(cb), cfg)
    assert got.shape == (2, 9, 40)
    _close(got, want)


@pytest.mark.parametrize("k, cfg", ODD_K, ids=ODD_IDS)
def test_expert_linear_at_odd_k_matches_reference(ref, k, cfg):
    """The stacked form against the reference's per-expert loop
    (``moe.py``: one ``s_x`` over every expert's rows)."""
    cb = _levels(cfg)
    e = 3
    x = _x((e, 5, k), k + 2)
    pairs = [_packed_pair(ref, (np.random.default_rng(k + i).standard_normal((k, 24))
                                * k**-0.5).astype(np.float32), cfg, cb) for i in range(e)]
    stack = ops.PackedOperand(*(torch.stack([getattr(t, f) for _, t in pairs])
                                for f in ("idx_packed", "sel_packed", "inv_scale")), k)
    jc, jcb = _jcfg(ref, cfg), ref.jnp.asarray(cb)
    s_x = ref.bcq.tensor_scale(ref.jnp.asarray(x), jc)
    want = np.stack([np.asarray(ref.jops.w4a4_linear_fused(ref.jnp.asarray(x[i]), pairs[i][0],
                                                           jcb, jc, s_x=s_x, impl="ref"))
                     for i in range(e)])
    got = ops.w4a4_linear_fused_experts(torch.from_numpy(x), stack, torch.from_numpy(cb), cfg)
    assert got.shape == (e, 5, 24)
    _close(got, want)


@pytest.mark.parametrize("k, cfg", ODD_K, ids=ODD_IDS)
def test_two_launch_gemm_at_odd_k_matches_reference(ref, k, cfg):
    cb = _levels(cfg)
    x = _x((13, k), k + 3)
    w = (np.random.default_rng(k + 4).standard_normal((k, 33)) * k**-0.5).astype(np.float32)
    jw, tw = _packed_pair(ref, w, cfg, cb)
    jc, jcb = _jcfg(ref, cfg), ref.jnp.asarray(cb)
    ja = ref.jops.quantize(ref.jnp.asarray(x), jcb, jc, impl="ref")
    want = ref.jops.matmul(ja, jw, jcb, jc, impl="ref")
    a = ops.quantize(torch.from_numpy(x), torch.from_numpy(cb), cfg)
    np.testing.assert_array_equal(a.inv_scale.numpy(), np.asarray(ja.inv_scale))
    got = ops.matmul(a, tw, torch.from_numpy(cb), cfg)
    _close(got, want)


def _fold(codes_a, a_inv, codes_w, w_inv, la):
    """The GEMM's per-array fold, array after array: acc + isum · (a_inv ·
    w_inv) with the product of scales rounded to f32, then one rounding
    of the sum (the kernel's fma)."""
    m, k = codes_a.shape
    ka = k // la
    isum = torch.einsum("mak,nak->mna", codes_a.reshape(m, ka, la),
                        codes_w.reshape(codes_w.shape[0], ka, la))
    acc = torch.zeros((m, codes_w.shape[0]), dtype=torch.float32)
    for kb in range(ka):
        s = (a_inv[:, kb][:, None] * w_inv[:, kb][None, :]).double()
        acc = (acc.double() + isum[..., kb].double() * s).float()
    return acc


def _codes(idx_p, sel_p, cb, cfg, k):
    idx = tbcq.unpack_nibbles(idx_p).long()[:, :k]
    sel = tbcq.unpack_nibbles(sel_p).long()[:, : k // cfg.block_len]
    return cb[torch.repeat_interleave(sel, cfg.block_len, dim=-1), idx].long()


@pytest.mark.parametrize("k, cfg", ODD_K, ids=ODD_IDS)
def test_padded_arrays_add_nothing(k, cfg):
    """What the card's wrappers launch at an odd K: x with zero columns up
    to ``pad_k`` (its extra arrays encode to finite, nonzero scales) and
    the weight through ``pad_weight`` (zero bytes, zero scales).  The
    per-array fold over the padded operands equals the fold over the
    unpadded ones bit for bit, and the plain linear of the padded tensors
    equals the unpadded one's within f32 sum order."""
    cb = torch.from_numpy(_levels(cfg))
    kp = build.pad_k(k)
    assert kp % 64 == 0 and kp > k and build.pad_k(kp) == kp
    x = torch.from_numpy(_x((11, k), k + 5))
    wenc = tbcq.encode(torch.from_numpy(_x((20, k), k + 6)) * k**-0.5, cb, cfg)
    w = ops.packed_operand({"idx": wenc.packed_idx, "sel": wenc.packed_sel,
                            "scale": wenc.scale_code, "s_x": wenc.s_x})
    s_x = tbcq.tensor_scale(x, cfg)
    pw = bcq_linear.pad_weight(w.idx_packed, w.sel_packed, w.inv_scale, kp, cfg)
    assert [t.shape[-1] for t in pw] == [kp // 2, kp // (2 * cfg.block_len), kp // cfg.array_len]
    assert all(not t[:, u:].any() for t, u in zip(pw, (k // 2, k // (2 * cfg.block_len),
                                                        k // cfg.array_len)))
    assert bcq_linear.pad_weight(*pw, kp, cfg)[0] is pw[0]  # a whole K: no copy
    xp = build.pad_last(x, kp)
    idx, sel, ratio = quantize_ref(xp, cb, cfg, s_x)
    a_inv = torch.ones_like(ratio) / (ratio * s_x)
    assert torch.isfinite(a_inv).all() and (a_inv[:, k // cfg.array_len:] > 0).all()
    padded = _fold(_codes(idx, sel, cb, cfg, kp), a_inv, _codes(pw[0], pw[1], cb, cfg, kp),
                   pw[2], cfg.array_len)
    ka = k // cfg.array_len
    whole = _fold(_codes(idx, sel, cb, cfg, k), a_inv[:, :ka],
                  _codes(w.idx_packed, w.sel_packed, cb, cfg, k), w.inv_scale, cfg.array_len)
    assert torch.equal(padded, whole)
    _close(fused_linear_ref(xp, *pw, cb, cfg, s_x).numpy(),
           fused_linear_ref(x, w.idx_packed, w.sel_packed, w.inv_scale, cb, cfg, s_x).numpy())


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(k, cfg, m, n, seed, device):
    cb = torch.as_tensor(_levels(cfg), device=device)
    x = torch.from_numpy(_x((m, k), seed)).to(device)
    w = (torch.from_numpy(_x((k, n), seed + 1)) * k**-0.5).to(device)
    return x, ops.packed_operand(tlayers.pack_weight(w, cfg, cb)), cb


def _held(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("k, cfg", ODD_K, ids=ODD_IDS)
def test_b1_and_b4_at_odd_k_match_plain(cuda, k, cfg, m):
    """B1 against its plain version, B3 then B4 against theirs, and the
    two W4A4 routes equal bit for bit: one launch each."""
    x, w, cb = _card_case(k, cfg, m, 200, m + k, cuda)
    s_x = tbcq.tensor_scale(x, cfg)
    build.reset_counts()
    fused = bcq_linear.bcq_linear(x, w.idx_packed, w.sel_packed, w.inv_scale, cb, s_x, cfg)
    _held(fused, fused_linear_ref(x, w.idx_packed, w.sel_packed, w.inv_scale, cb, cfg, s_x))
    a = ops.quantize(x, cb, cfg, s_x=s_x)
    two = bcq_matmul.bcq_matmul(a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed,
                                w.sel_packed, w.inv_scale, cb, cb, cfg)
    _held(two, matmul_ref(a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed, w.sel_packed,
                          w.inv_scale, cb, cb, cfg))
    counts = build.counts()
    assert counts["bcq_linear"] == 1 and counts["bcq_matmul"] == 1
    assert torch.equal(fused, two)


@pytest.mark.cuda
@pytest.mark.parametrize("k, cfg", ODD_K, ids=ODD_IDS)
def test_b1s_at_odd_k_matches_plain_and_per_expert_b1(cuda, k, cfg):
    e, c = 4, 64
    cases = [_card_case(k, cfg, c, 96, 30 + i, cuda) for i in range(e)]
    cb = cases[0][2]
    x = torch.stack([xc for xc, _, _ in cases])
    idx, sel, inv = (torch.stack([getattr(w, f) for _, w, _ in cases])
                     for f in ("idx_packed", "sel_packed", "inv_scale"))
    s_x = tbcq.tensor_scale(x, cfg)
    build.reset_counts()
    got = bcq_linear.bcq_linear_experts(x, idx, sel, inv, cb, s_x, cfg)
    assert build.counts()["bcq_linear_experts"] == 1
    _held(got, fused_linear_experts_ref(x, idx, sel, inv, cb, cfg, s_x))
    per = torch.stack([bcq_linear.bcq_linear(x[i], idx[i], sel[i], inv[i], cb, s_x, cfg)
                       for i in range(e)])
    assert torch.equal(got, per)
