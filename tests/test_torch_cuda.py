"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and a smoke-size serving run through the kernels against the
plain paths.  Marked ``cuda``; each test decides inside its fixture
whether a card is present and skips here otherwise (a CUDA kernel has no
interpret mode).  Run on the card with::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py

Tolerances: fused linear, W4A4 matmul and the two-launch linear
``rtol=1e-5, atol=1e-5·max|plain|`` (the encode is bit-identical; the
kernels sum each 64-wide array exactly in int32 and rescale it once,
where the plain versions round every decoded value before an f32 dot);
the two W4A4 routes equal to the bit (the same codes, scales and fold
order); quantize bytes equal (decoded values equal
where a block ties between codebooks) and ratios exactly equal; the KV
page writer's pool bytes equal to the plain writer's (the same f32
errors in the same order: a tie resolves alike);
page-gather ``atol=rtol=2e-5`` (softmax and accumulation order differ);
flash attention ``atol=rtol=2e-4`` for f32 inputs, as
tests/test_flash_kernel.py, and ``1e-2`` for bf16 (the output's bf16
rounding of two f32 sums taken in different orders); serving tokens equal
under the margin rule with a 1e-3 logit tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke
from repro_torch.core import bcq
from repro_torch.core.calibrate import default_universal_codebooks
from repro_torch.kernels import bcq_linear, bcq_matmul, bcq_quantize, build, common, ops
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels.ref import decode_ref, fused_linear_ref, matmul_ref, quantize_ref
from repro_torch.launch.serve import serve
from repro_torch.models import layers
from repro_torch.serving.generate import greedy_agreement

CFG = bcq.BCQConfig()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cb(device):
    return default_universal_codebooks().as_tensor(device)


# decode (M ≤ 16: the swapped small-M GEMM), ragged and prefill rows, at
# gpt3_126m's linear widths and a ragged one
GEMM_M = [1, 8, 16, 37, 300]
GEMM_KN = [(768, 768), (768, 3072), (3072, 768), (192, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("kn", GEMM_KN, ids=lambda kn: f"K{kn[0]}_N{kn[1]}")
@pytest.mark.parametrize("m", GEMM_M)
def test_bcq_linear_kernel_matches_plain(cuda, m, kn):
    k, n = kn
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g)
    x[:, :: k // 8] *= 12.0
    x = x.to(cuda)
    w = (torch.randn((k, n), generator=g) * k**-0.5).to(cuda)
    cb = _cb(cuda)
    pw = ops.packed_operand(layers.pack_weight(w, CFG, cb))
    s_x = bcq.tensor_scale(x, CFG)
    before = bcq_linear.BCQ_LINEAR.count
    got = bcq_linear.bcq_linear(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, s_x, CFG)
    want = fused_linear_ref(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, CFG, s_x, valid_k=k)
    assert bcq_linear.BCQ_LINEAR.count == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def _activation(m, k, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    x[:, :: k // 8] *= 12.0  # outlier channels
    return x.to(device)


def _packed(n, k, seed, device):
    w = (torch.randn((k, n), generator=torch.Generator().manual_seed(seed)) * k**-0.5).to(device)
    return ops.packed_operand(layers.pack_weight(w, CFG, _cb(device)))


@pytest.mark.cuda
@pytest.mark.parametrize("mk", [(256, 768), (64, 3072), (37, 192)])
def test_bcq_quantize_kernel_matches_plain(cuda, mk):
    m, k = mk
    x, cb = _activation(m, k, m + k, cuda), _cb(cuda)
    s_x = bcq.tensor_scale(x, CFG)
    before = bcq_quantize.BCQ_QUANTIZE.count
    idx, sel, ratio = bcq_quantize.bcq_quantize(x, cb, s_x, CFG)
    assert bcq_quantize.BCQ_QUANTIZE.count == before + 1
    r_idx, r_sel, r_ratio = quantize_ref(x, cb, CFG, s_x)
    assert torch.equal(ratio, r_ratio)
    if not (torch.equal(idx, r_idx) and torch.equal(sel, r_sel)):  # a codebook tie
        inv = 1.0 / (r_ratio * s_x)
        assert torch.equal(decode_ref(idx, sel, inv, cb, CFG), decode_ref(r_idx, r_sel, inv, cb, CFG))


@pytest.mark.cuda
@pytest.mark.parametrize("mk", [(8192, 768), (8192, 3072), (37, 192)])
def test_bcq_quantize_kernel_matches_plain_at_evaluation_shapes(cuda, mk):
    """The redesigned encode (banked table, prefetched grid-stride steps)
    at the two-launch GEMM's activation shapes and a ragged one."""
    m, k = mk
    x, cb = _activation(m, k, 3 * m + k, cuda), _cb(cuda)
    s_x = bcq.tensor_scale(x, CFG)
    idx, sel, ratio = bcq_quantize.bcq_quantize(x, cb, s_x, CFG)
    r_idx, r_sel, r_ratio = quantize_ref(x, cb, CFG, s_x)
    assert torch.equal(ratio, r_ratio)
    if not (torch.equal(idx, r_idx) and torch.equal(sel, r_sel)):  # a codebook tie
        inv = 1.0 / (r_ratio * s_x)
        assert torch.equal(decode_ref(idx, sel, inv, cb, CFG), decode_ref(r_idx, r_sel, inv, cb, CFG))


@pytest.mark.cuda
@pytest.mark.parametrize("mk", [(8, 768), (8192, 768), (37, 3072)])
def test_bcq_linear_encode_pass_bytes_match_quantize_ref(cuda, mk):
    """B1's first launch shares B3's encode pass: its int8 codes are
    cb[sel][idx] of quantize_ref's bytes and its scales 1 / (ratio · s_x)."""
    m, k = mk
    x, cb = _activation(m, k, m + 2 * k, cuda), _cb(cuda)
    s_x = bcq.tensor_scale(x, CFG)
    w = _packed(64, k, 5, cuda)
    codes = torch.empty((m, k), dtype=torch.int8, device=cuda)
    a_inv = torch.empty((m, k // 64), dtype=torch.float32, device=cuda)
    out = torch.empty((m, 64), dtype=torch.float32, device=cuda)
    status = build.library().bcq_linear_launch(
        x.data_ptr(), w.idx_packed.data_ptr(), w.sel_packed.data_ptr(), w.inv_scale.data_ptr(),
        cb.data_ptr(), s_x.data_ptr(), codes.data_ptr(), a_inv.data_ptr(), out.data_ptr(), m, 64,
        k, CFG.codeword_max, *build.format_args(CFG), 1, 1,
        torch.cuda.current_stream(cuda).cuda_stream)
    build.check(status, "bcq_linear_launch")
    r_idx, r_sel, r_ratio = quantize_ref(x, cb, CFG, s_x)
    sel = torch.repeat_interleave(bcq.unpack_nibbles(r_sel).long(), 8, dim=-1)
    want = cb[sel, bcq.unpack_nibbles(r_idx).long()].to(torch.int8)
    assert torch.equal(codes, want)
    assert torch.equal(a_inv, torch.ones_like(r_ratio) / (r_ratio * s_x))


def _kv_write_case(c, d, h, dtype, cuda, seed=0):
    """A 3-layer stacked bcq4 pool of random bytes (so every write shows),
    v_sx non-unit, and one layer's new K/V: an all-zero head, a head of
    codeword midpoints (K, s_x = 1: y = x exactly), an outlier.  C == 1:
    8 decode rows, 5 at their own slots, 3 idle on the null page's slot 0
    holding different tokens.  C > 1: 8 rows of a chunk over pages of 16 —
    full rows, a ragged last chunk, a row whose last pages lie wholly past
    its chunk (routed to the null page) and a pad row."""
    ps, b, n_pages = 16, 8, 40
    g = torch.Generator().manual_seed(seed)
    one = layers.cache_init(n_pages, ps, h, d, "bcq4", CFG, device="cpu")
    stacked = {n: (torch.randint(0, 256, (3,) + t.shape, generator=g, dtype=torch.uint8)
                   if t.ndim else torch.tensor([1.0, 0.37, 2.5])) for n, t in one.items()}
    stacked["k_sx"] = torch.tensor([0.5, 1.0, 3.0])
    stacked = {n: t.to(cuda) for n, t in stacked.items()}
    k = torch.randn((b, c, h, d), generator=g) * 1.5
    v = torch.randn((b, c, h, d), generator=g) * torch.randn((b, c, h, 1), generator=g).exp()
    k[0, :, 0] = 0.0
    cbn = _cb("cpu")
    thr = (0.5 * (cbn[:, 1:] + cbn[:, :-1])).reshape(-1)
    k[1, :, -1] = thr[torch.randint(0, thr.numel(), (c, d), generator=g)]
    k[1, :, -1, 0] = 31.0
    v[2, 0, 0, 5] *= 40.0
    kw = {}
    if c == 1:
        kw["page_ids"] = torch.tensor([3, 1, 3, 0, 5, 0, 6, 0], device=cuda)
        kw["offsets"] = torch.tensor([2, 15, 5, 0, 0, 0, 9, 0], dtype=torch.int32, device=cuda)
    else:
        n_cp = -(-c // ps)
        ids = torch.arange(1, 1 + b * n_cp, dtype=torch.int32).reshape(b, n_cp)
        chunk_len = torch.full((b,), c, dtype=torch.int32)
        chunk_len[3], chunk_len[5], chunk_len[6] = c - 5, ps + 3, 0
        ids[5, 2:] = 0  # wholly past the row's chunk
        ids[6] = 0  # a pad row
        kw["chunk_page_ids"], kw["chunk_len"] = ids.to(cuda), chunk_len.to(cuda)
    return stacked, k.to(cuda, dtype), v.to(cuda, dtype), kw


def _layers_write(pool, k, v, cb, kw, kernel):
    """One layer's page write through ``layers``: the kernel, or with
    ``kernel=False`` the plain writer."""
    if "chunk_page_ids" in kw:
        return layers.paged_chunk_write(pool, k, v, kw["chunk_page_ids"], "bcq4", CFG, cb,
                                        kw["chunk_len"], kernel=kernel)
    return layers.paged_token_write(pool, k, v, kw["page_ids"], kw["offsets"], "bcq4", CFG, cb,
                                    kernel=kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h", [(64, 12), (16, 4), (32, 4), (128, 4)])
@pytest.mark.parametrize("c", [1, 64])
def test_page_write_kernel_matches_plain(cuda, c, d, h, dtype):
    """The writer against the plain writer, byte for byte, on layer 1 of a
    layer-stacked pool; layers 0 and 2 stay untouched."""
    stacked, k, v, kw = _kv_write_case(c, d, h, dtype, cuda, seed=c + d)
    before = {n: t.clone() for n, t in stacked.items()}
    pool = {n: t[1] for n, t in stacked.items()}
    plain = {n: t[1].clone() for n, t in stacked.items()}
    cb = _cb(cuda)
    n0 = bcq_quantize.BCQ_PAGE_WRITE.count
    bcq_quantize.bcq_page_write(pool, k, v, CFG, cb, **kw)
    assert bcq_quantize.BCQ_PAGE_WRITE.count == n0 + 1
    _layers_write(plain, k, v, cb, kw, kernel=False)
    for n in stacked:
        assert torch.equal(pool[n], plain[n]), n
        assert torch.equal(stacked[n][0], before[n][0]) and torch.equal(stacked[n][2], before[n][2])


@pytest.mark.cuda
def test_page_write_through_layers_selects_the_kernel(cuda):
    """Runtime.paged_kernel routes bcq4 page writes to the kernel; other
    page kinds and the flag off take the plain write."""
    stacked, k, v, kw = _kv_write_case(1, 64, 12, torch.float32, cuda)
    pool = {n: t[0] for n, t in stacked.items()}
    cb = _cb(cuda)
    build.reset_counts()
    layers.paged_token_write(pool, k, v, kw["page_ids"], kw["offsets"], "bcq4", CFG, cb, kernel=True)
    layers.paged_token_write(pool, k, v, kw["page_ids"], kw["offsets"], "bcq4", CFG, cb)
    assert build.counts()["bcq_page_write"] == 1


@pytest.mark.cuda
def test_smoke_serving_writes_pages_through_the_kernel(cuda):
    cfg = get_smoke("gpt3_126m")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (9, 30, 17)]
    kw = dict(page_size=8, prefill_chunk=16, device=cuda, chunked_prefill=True,
              prefix_caching=False)
    build.reset_counts()
    _, eng = serve(cfg, prompts, 5, kernels=True, **kw)
    passes = eng.stats["decode_ticks"] + eng.stats["prefill_launches"]
    assert build.counts()["bcq_page_write"] == cfg.n_layers * passes
    build.reset_counts()
    serve(cfg, prompts, 5, kernels=False, **kw)
    assert build.counts().get("bcq_page_write", 0) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kn", GEMM_KN, ids=lambda kn: f"K{kn[0]}_N{kn[1]}")
@pytest.mark.parametrize("m", GEMM_M)
def test_bcq_matmul_kernel_matches_plain(cuda, m, kn):
    k, n = kn
    cb = _cb(cuda)
    a = ops.quantize(_activation(m, k, m, cuda), cb, CFG)
    w = _packed(n, k, n, cuda)
    args = (a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed, w.sel_packed, w.inv_scale,
            cb, cb, CFG)
    before = bcq_matmul.BCQ_MATMUL.count
    got = bcq_matmul.bcq_matmul(*args)
    assert bcq_matmul.BCQ_MATMUL.count == before + 1
    want = matmul_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_two_launch_linear_matches_fused(cuda):
    cb = _cb(cuda)
    x = _activation(300, 768, 1, cuda).reshape(3, 100, 768)
    w = _packed(3072, 768, 2, cuda)
    build.reset_counts()
    got = ops.w4a4_linear(x, w, cb, CFG)
    assert build.counts()["bcq_quantize"] == 1 and build.counts()["bcq_matmul"] == 1
    want = ops.w4a4_linear_fused(x, w, cb, CFG)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 300])
def test_two_routes_bit_equal(cuda, m):
    """The fused linear and the two-launch GEMM multiply the same codes
    with the same scales and fold each array in the same order."""
    cb = _cb(cuda)
    x = _activation(m, 768, 3, cuda)
    w = _packed(3072, 768, 4, cuda)
    assert torch.equal(ops.w4a4_linear(x, w, cb, CFG), ops.w4a4_linear_fused(x, w, cb, CFG))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(128, 64), (200, 32), (384, 128)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, s, d):
    g = torch.Generator().manual_seed(s + d)
    q, k, v = (torch.randn((6, s, d), generator=g).to(cuda, dtype) for _ in range(3))
    before = flash.FLASH_ATTENTION.count
    got = flash.flash_attention_kernel(q, k, v, causal)
    assert flash.FLASH_ATTENTION.count == before + 1
    want = flash.flash_attention_plain(q, k, v, causal)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    tol = 2e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 200, 2048])
def test_flash_bf16_tensor_core_tile_edges(cuda, s, d, causal):
    """The bf16 tensor-core kernel at lengths around its 64-row tiles:
    one key, a tile minus one, a tile plus one, ragged, the evaluation's
    2048."""
    g = torch.Generator().manual_seed(7 * s + d)
    q, k, v = (torch.randn((3, s, d), generator=g).to(cuda, torch.bfloat16) for _ in range(3))
    got = flash.flash_attention_kernel(q, k, v, causal)
    want = flash.flash_attention_plain(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_flash_gqa_wrapper_matches_plain(cuda):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 256, 8, 64), generator=g).to(cuda)
    k, v = (torch.randn((2, 256, 2, 64), generator=g).to(cuda) for _ in range(2))
    got = flash.flash_attention(q, k, v)
    want = layers._attend_chunked(q, k, v, torch.arange(256, device=cuda)[None].expand(2, 256), 256)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
@pytest.mark.parametrize("c,d,h,hkv", [(1, 64, 12, 12), (8, 32, 4, 2), (1, 128, 16, 16),
                                       (8, 128, 16, 16)])
def test_page_gather_kernel_matches_plain(cuda, kind, c, d, h, hkv):
    ps, n_pages, maxp = 8, 9, 4
    g = torch.Generator().manual_seed(0)
    pool = layers.cache_init(n_pages, ps, hkv, d, kind, CFG, device=cuda)
    k = torch.randn((n_pages, ps, hkv, d), generator=g).to(cuda)
    v = torch.randn((n_pages, ps, hkv, d), generator=g).to(cuda)
    cb = _cb(cuda)
    for name, val in layers.cache_encode(k, v, kind, CFG, cb, pool).items():
        pool[name].copy_(val)
    kv_len = [0, ps, 2 * ps + 3, maxp * ps] if c == 1 else [c, ps + c, 0, maxp * ps]
    bt = torch.randint(1, n_pages, (4, maxp), generator=g, dtype=torch.int32)
    for r, n in enumerate(kv_len):
        bt[r, -(-n // ps):] = 0  # NULL past the live pages
    bt, kvl = bt.to(cuda), torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    q = torch.randn((4, c, h, d), generator=g).to(cuda)
    before = common.PAGE_GATHER.count
    got = common.page_gather_attention(q, pool, bt, kvl, kind, CFG, cb)
    want = common.page_gather_attention_plain(q, pool, bt, kvl, kind, CFG, cb)
    assert common.PAGE_GATHER.count == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def _long_rows_case(kind, c, cuda, seed=0):
    """Rows long enough for several splits: lengths on and just past a
    split edge (its last page holds a few tokens), a zero-length row, a
    full table; NULL padding past each row's live pages."""
    ps, hkv, d, h = 16, 2, 64, 4
    sp = common.SPLIT_PAGES
    maxp = 3 * sp + 2
    n_pages = maxp + 7
    g = torch.Generator().manual_seed(seed)
    pool = layers.cache_init(n_pages, ps, hkv, d, kind, CFG, device=cuda)
    kv = [torch.randn((n_pages, ps, hkv, d), generator=g).to(cuda) for _ in range(2)]
    for name, val in layers.cache_encode(*kv, kind, CFG, _cb(cuda), pool).items():
        pool[name].copy_(val)
    kv_len = [0, sp * ps, sp * ps + 3, 2 * sp * ps + 1, maxp * ps - 5, maxp * ps]
    if c > 1:
        kv_len = [max(n, c) for n in kv_len]
        kv_len[0] = 0  # a zero-length row under a full chunk
    bt = torch.randint(1, n_pages, (len(kv_len), maxp), generator=g, dtype=torch.int32)
    for r, n in enumerate(kv_len):
        bt[r, -(-n // ps):] = 0
    q = torch.randn((len(kv_len), c, h, d), generator=g).to(cuda)
    return (q, pool, bt.to(cuda), torch.tensor(kv_len, dtype=torch.int32, device=cuda), kind,
            CFG, _cb(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 64])
@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
def test_page_gather_split_kv_long_rows_match_plain(cuda, kind, c):
    args = _long_rows_case(kind, c, cuda)
    got = common.page_gather_attention(*args)
    want = common.page_gather_attention_plain(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 64])
def test_page_gather_split_kv_is_deterministic(cuda, c):
    """The splits' partials merge in ascending split order, without
    atomics: two launches give the same bits."""
    args = _long_rows_case("bcq4", c, cuda, seed=1)
    first = common.page_gather_attention(*args)
    second = common.page_gather_attention(*args)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_smoke_eval_loss_through_kernels_matches_plain(cuda):
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import zoo

    cfg = get_smoke("gpt3_126m")
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2), 1_000_000, cuda)
    rt = layers.Runtime(quant_mode="packed", compute_dtype=torch.float32)
    api_k = zoo.build(cfg, dataclasses.replace(rt, flash_kernel=True), device=cuda)
    api_p = zoo.build(cfg, dataclasses.replace(rt, fused_linear=False), device=cuda)
    params = api_k.init(0)
    build.reset_counts()
    got = float(api_k.loss_fn(params, batch))
    assert build.counts()["flash_attention"] == cfg.n_layers
    assert build.counts()["bcq_linear"] == cfg.n_layers * 6
    build.reset_counts()
    want = float(api_p.loss_fn(params, batch))
    assert not any(build.counts().values())
    assert abs(got - want) <= 1e-3 * abs(want)


@pytest.mark.cuda
def test_smoke_serving_kernels_match_plain_paths(cuda):
    cfg = get_smoke("gpt3_126m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 37, 12, 20)]
    build.reset_counts()
    kw = dict(page_size=8, prefill_chunk=16, device=cuda, chunked_prefill=True,
              prefix_caching=False)
    fin_k, eng = serve(cfg, prompts, 6, kernels=True, **kw)
    counts = build.counts()
    fin_p, _ = serve(cfg, prompts, 6, kernels=False, **kw)
    passes = eng.stats["decode_ticks"] + eng.stats["prefill_launches"]
    assert counts["bcq_linear"] == cfg.n_layers * 6 * passes
    assert counts["page_gather"] == cfg.n_layers * passes
    agree = greedy_agreement({r.rid: r for r in fin_p}, {r.rid: r for r in fin_k}, 1e-3)
    assert agree["ok"], agree


# ------------------------------------------------------------ serving core
@pytest.mark.cuda
def test_prng_bits_and_uniforms_on_cuda_equal_cpu(cuda):
    from repro_torch.serving import generate, prng

    rows = torch.tensor([[0, 0, 0], [1234, 2, 333], [2**31 - 1, 1, 4095]])
    keys = generate.sampling_keys(rows)
    keys_dev = generate.sampling_keys(rows.to(cuda))
    assert torch.equal(keys_dev.cpu(), keys)
    assert torch.equal(prng.random_bits(keys_dev, 50_257).cpu(), prng.random_bits(keys, 50_257))
    u, u_dev = (prng.uniform(k, 50_257, prng.F32_TINY, 1.0) for k in (keys, keys_dev))
    assert torch.equal(u_dev.cpu().view(torch.int32), u.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
def test_page_moves_on_cuda_equal_cpu(cuda, kind):
    from repro_torch.models import transformer
    from repro_torch.serving import pages

    cfg = get_smoke("gpt3_126m")
    rt = layers.Runtime(cache_kind=kind)
    g = torch.Generator().manual_seed(3)

    def filled(n_pages, ps):
        tree = transformer.cache_init_stacked(cfg, rt, n_pages, ps)
        for n, leaf in tree.items():
            if leaf.ndim >= 3:
                leaf.copy_((torch.rand(leaf.shape, generator=g) * 200 - 100).to(leaf.dtype))
        return tree

    pool, cache1 = filled(7, 8), filled(1, 32)
    dev = {n: t.to(cuda) for n, t in pool.items()}
    dev1 = {n: t.to(cuda) for n, t in cache1.items()}
    ids = torch.tensor([0, 3, 0, 5], dtype=torch.int32)
    for tree, c1, i in ((pool, cache1, ids), (dev, dev1, ids.to(cuda))):
        pages.copy_page(tree, 2, 6)
        pages.scatter_prefill_pages(tree, c1, i)
    for n in pool:
        assert torch.equal(dev[n].cpu(), pool[n]), n


@pytest.mark.cuda
def test_smoke_engine_serving_core_on_card(cuda):
    """Prefix hits, a sampled fork with copy-on-write and preemption through
    the kernels on the card; the page accounting ends clean."""
    from repro_torch.models import zoo
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.generate import Request, SamplingParams

    cfg = get_smoke("gpt3_126m")
    rt = layers.Runtime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                        paged_kernel=True)
    api = zoo.build(cfg, rt, device=cuda)
    eng = PagedEngine(api, api.init(0), n_slots=4, max_len=64, page_size=8, n_pages=14,
                      watermark=1, chunked_prefill=True, prefill_chunk=16, device=cuda)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab, 24)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=np.concatenate([shared, rng.integers(0, cfg.vocab, 5)]),
                           max_new=24, n_samples=2 if rid == 1 else 1,
                           sampling=SamplingParams(0.8, 40, 1234) if rid == 1 else SamplingParams()))
    build.reset_counts()
    finished, _ = eng.run_to_completion()
    passes = eng.stats["decode_ticks"] + eng.stats["prefill_launches"]
    assert build.counts()["page_gather"] == cfg.n_layers * passes
    assert sorted((r.rid, r.sample_idx) for r in finished) == [(0, 0), (1, 0), (1, 1), (2, 0),
                                                               (3, 0)]
    for key in ("prefix_hits", "forks", "cow_copies", "preemptions"):
        assert eng.stats[key] > 0, (key, eng.stats)
    assert (eng.pool_mgr.refcount == 0).all()
    free, parked = set(eng.pool_mgr.free), set(eng.prefix.reclaimable)
    assert not free & parked and free | parked == set(range(1, 14))
    assert parked == set(eng.prefix.hash_of)


# ------------------------------------------------------------- PTQ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 768), (3, 5, 200), (4096, 3072)])
def test_fake_quant_route_through_quantize_kernel(cuda, shape):
    """``bcq.fake_quant`` of a CUDA tensor launches B3 once and decodes to the
    plain route's values bit for bit (K padded to whole arrays, any lead)."""
    x = _activation(int(np.prod(shape[:-1])), shape[-1], sum(shape), cuda).reshape(shape)
    cb = _cb(cuda)
    before = bcq_quantize.BCQ_QUANTIZE.count
    got = bcq.fake_quant(x, cb, CFG)
    assert bcq_quantize.BCQ_QUANTIZE.count == before + 1
    assert torch.equal(got, bcq.fake_quant_plain(x, cb, CFG))
    assert torch.equal(bcq.fake_quant(x.bfloat16(), cb, CFG),
                       bcq.fake_quant_plain(x.bfloat16(), cb, CFG))


@pytest.mark.cuda
def test_kernels_refuse_a_non_integer_codebook(cuda):
    """The premise moved from ``CodebookSet`` to the kernels' entry: a
    non-integer book loads, the kernels that multiply int8 codes (B1 here;
    B4 and the page writer in ``test_integer_premise_kernels_refuse_trained_books``)
    refuse it with the same message, and B3's quantize form — the fake
    modes' route — takes it through its threshold search, as the
    reference's kernel does: the decoded values of ``fake_quant`` are the
    plain route's, bit for bit (no silent plain fallback: one B3 launch)."""
    lv = default_universal_codebooks().levels.copy()
    lv[3, 5] += 0.5
    bad = bcq.CodebookSet(lv, CFG).as_tensor(cuda)
    x = _activation(8, 768, 3, cuda)
    s_x = bcq.tensor_scale(x, CFG)
    w = _packed(64, 768, 5, cuda)
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        bcq_linear.bcq_linear(x, w.idx_packed, w.sel_packed, w.inv_scale, bad, s_x, CFG)
    before = bcq_quantize.BCQ_QUANTIZE_THR.count
    got = bcq.fake_quant(x, bad, CFG)
    assert bcq_quantize.BCQ_QUANTIZE_THR.count == before + 1
    assert torch.equal(got, bcq.fake_quant_plain(x, bad, CFG))


@pytest.mark.cuda
def test_lobcq_fit_on_card_is_deterministic(cuda):
    """Two fits on the card give the same bytes (one-hot products, no atomic
    adds), a non-increasing history, and the CPU fit's codebooks."""
    g = torch.Generator().manual_seed(7)
    samples = [torch.randn(200_000, generator=g),
               torch.distributions.Laplace(0.0, 1.0).sample((100_000,)),
               torch.randn(65_536, generator=g) * 4]
    fits = [bcq.fit_lobcq([s.to(cuda) for s in samples], CFG, iters=6, lm_iters=10)
            for _ in range(2)]
    assert fits[0].levels.tobytes() == fits[1].levels.tobytes()
    assert fits[0].history == fits[1].history
    h = fits[0].history
    assert all(b <= a for a, b in zip(h, h[1:])), h
    cpu = bcq.fit_lobcq(samples, CFG, iters=6, lm_iters=10)
    np.testing.assert_array_equal(cpu.levels, fits[0].levels)
    np.testing.assert_allclose(cpu.history, h, rtol=2e-4)


@pytest.mark.cuda
def test_smoke_fake_modes_through_the_quantize_kernel(cuda):
    """The fake modes on the card (every BCQ encode through B3) against the
    same model on the CPU (the plain encode): the loss within 1e-4."""
    from repro_torch.models import zoo

    cfg = get_smoke("gpt3_126m")
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for mode in ("fake", "fake_full"):
        rt = layers.Runtime(quant_mode=mode, compute_dtype=torch.float32)
        api_c, api_g = zoo.build(cfg, rt, device="cpu"), zoo.build(cfg, rt, device=cuda)
        params = api_c.init(0)
        before = bcq_quantize.BCQ_QUANTIZE.count
        loss_g = float(api_g.loss_fn(_tree_to(params, cuda),
                                     {k: v.to(cuda) for k, v in batch.items()}))
        per_layer = 4 if mode == "fake" else 10  # activations (+ the 6 weights in-graph)
        assert bcq_quantize.BCQ_QUANTIZE.count - before == per_layer * cfg.n_layers
        assert abs(loss_g - float(api_c.loss_fn(params, batch))) < 1e-4


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


# ------------------------------------------------ the state-checkpoint layout
# mamba2_130m's projections: in_proj 768 → 3352 (3352 = 8 · 419, no multiple
# of 16: the kernel masks the ragged N), out_proj 1536 → 768; M 8 (a decode
# tick of 8 slots) and 500 (the longest prefill of chip_smoke's workload)
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 768, 3352), (500, 768, 3352), (8, 1536, 768),
                                   (500, 1536, 768)])
def test_bcq_linear_at_the_ssm_shapes(cuda, m, k, n):
    g = torch.Generator().manual_seed(m + n)
    x = (torch.randn((m, k), generator=g) * 3.0).to(cuda)
    w = (torch.randn((k, n), generator=g) * k**-0.5).to(cuda)
    cb = _cb(cuda)
    pw = ops.packed_operand(layers.pack_weight(w, CFG, cb))
    s_x = bcq.tensor_scale(x, CFG)
    got = bcq_linear.bcq_linear(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, s_x, CFG)
    want = fused_linear_ref(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, CFG, s_x, valid_k=k)
    assert got.shape == (m, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_state_checkpoint_rows_with_null_duplicates_is_deterministic(cuda):
    """Every row not checkpointing scatters into the null page: last row
    wins (``layers._last_writer``), run after run, as on the CPU."""
    from repro_torch.serving import pages

    g = torch.Generator().manual_seed(0)
    live = {"ssm_state": torch.randn((2, 64, 3, 4, 8), generator=g),
            "conv_state": torch.randn((2, 64, 3, 20), generator=g)}
    axes = {"ssm_state": 1, "conv_state": 1}
    dsts = torch.zeros(64, dtype=torch.int32)
    dsts[5], dsts[40] = 3, 7

    def pool(device):
        return {"ssm_state": torch.zeros((9, 2, 3, 4, 8), device=device),
                "conv_state": torch.zeros((9, 2, 3, 20), device=device)}

    want = pages.state_checkpoint_rows(pool("cpu"), live, axes, dsts)
    live_d = {k: v.to(cuda) for k, v in live.items()}
    for _ in range(5):
        got = pages.state_checkpoint_rows(pool(cuda), live_d, axes, dsts.to(cuda))
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), k
    assert torch.equal(want["ssm_state"][0], live["ssm_state"][:, 63])


@pytest.mark.cuda
def test_state_decode_graph_equals_eager(cuda):
    """The smoke mamba2 through StatePagedEngine on the card: graph depth 2
    ≡ eager depth 1 bit for bit (tokens, margins, counters, live tree and
    state pool), a preemption and a fork among them; two graphs (with and
    without the checkpoint scatter), B1 launched 2 × layers a pass."""
    from repro_torch.launch.serve import build_model
    from repro_torch.serving.generate import Request
    from repro_torch.serving.pages import tree_leaves
    from repro_torch.serving.state_engine import StatePagedEngine

    api, params = build_model(get_smoke("mamba2_130m"), device="cuda")
    prompts = [np.random.default_rng(i).integers(0, 512, n) for i, n in enumerate((12, 9, 30))]
    outs = []
    for graphs, depth in ((False, 1), (True, 2)):
        build.reset_counts()
        eng = StatePagedEngine(api, params, n_slots=4, max_len=64, page_size=8,
                               pipeline_depth=depth, cuda_graphs=graphs)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=17, n_samples=2 if i == 1 else 1))
        for _ in range(5):
            eng.step()
        eng._preempt_one(None)
        fin, _ = eng.run_to_completion()
        torch.cuda.synchronize()
        outs.append(([(r.rid, r.sample_idx, r.out, r.margins) for r in
                      sorted(fin, key=lambda r: (r.rid, r.sample_idx))],
                     eng.health()["state_counters"],
                     [t.cpu() for t in tree_leaves(eng.live) + tree_leaves(eng.spool)],
                     build.counts().get("bcq_linear", 0)))
        if graphs:
            assert sorted(eng._graphs.buckets) == [False, True]
    (a, ca, ta, na), (b, cb_, tb, nb) = outs
    assert a == b and ca == cb_ and na == nb
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert na > 0 and na % (2 * 2) == 0  # 2 projections × 2 layers a pass


# ---------------------------------------------------------- the hybrid family
# recurrentgemma_9b's projections no other path runs: mlp-out 12288 → 4096
# (the largest K) at M 1 (a batch-1 replay), 8 (a decode tick of 8 slots)
# and 2,100 (the longest prompt of chip_smoke's ring run); the one KV head's
# 4096 → 256 and mlp-in 4096 → 12288 at M 8
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 12288, 4096), (8, 12288, 4096), (2100, 12288, 4096),
                                   (8, 4096, 256), (8, 4096, 12288)])
def test_bcq_linear_at_the_hybrid_shapes(cuda, m, k, n):
    g = torch.Generator().manual_seed(m + n + 1)
    x = (torch.randn((m, k), generator=g) * 3.0).to(cuda)
    w = (torch.randn((k, n), generator=g) * k**-0.5).to(cuda)
    cb = _cb(cuda)
    pw = ops.packed_operand(layers.pack_weight(w, CFG, cb))
    s_x = bcq.tensor_scale(x, CFG)
    before = bcq_linear.BCQ_LINEAR.count
    got = bcq_linear.bcq_linear(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, s_x, CFG)
    want = fused_linear_ref(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, CFG, s_x, valid_k=k)
    assert got.shape == (m, n) and bcq_linear.BCQ_LINEAR.count == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_state_checkpoint_rows_over_the_hybrid_tree_is_deterministic(cuda):
    """The smoke hybrid's live tree (ring leaves, ``pos_buf``, the
    ``REPLICATED`` s_X, tail states) checkpointed with duplicate null-page
    rows: last row wins, run after run, as on the CPU; the s_X stay."""
    import dataclasses

    from repro_torch.models import hybrid
    from repro_torch.serving import pages

    cfg = dataclasses.replace(get_smoke("recurrentgemma_9b"), n_layers=5)
    rt = layers.Runtime(cache_kind="bcq4")
    axes = pages.state_batch_axes(lambda b: hybrid.hybrid_cache_init(cfg, rt, b, "meta"))
    g = torch.Generator().manual_seed(1)

    def rand(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=g).to(t.dtype)
        return torch.randint(0, 100, t.shape, generator=g).to(t.dtype)

    live = pages._tree_map(rand, hybrid.hybrid_cache_init(cfg, rt, 16))
    dsts = torch.zeros(16, dtype=torch.int32)
    dsts[3], dsts[11] = 2, 5
    want = pages.state_checkpoint_rows(
        pages.state_pool_init(lambda b: hybrid.hybrid_cache_init(cfg, rt, b), axes, 7), live,
        axes, dsts)
    live_d = pages._tree_map(lambda t: t.to(cuda), live)
    for _ in range(5):
        got = pages.state_checkpoint_rows(
            pages.state_pool_init(lambda b: hybrid.hybrid_cache_init(cfg, rt, b, cuda), axes, 7),
            live_d, axes, dsts.to(cuda))
        for a, b in zip(pages.tree_leaves(got), pages.tree_leaves(want)):
            assert torch.equal(a.cpu(), b)
    ring = want["periods"]["b2"]
    assert torch.equal(ring["pos_buf"][0], live["periods"]["b2"]["pos_buf"][:, 15])
    assert torch.equal(ring["k_sx"], torch.ones(1))


@pytest.mark.cuda
def test_hybrid_state_decode_graph_equals_eager(cuda):
    """The smoke hybrid (bcq4 ring, window 32) through StatePagedEngine on
    the card: graph depth 2 ≡ eager depth 1 bit for bit (tokens, margins,
    counters, live tree and state pool) with a preemption and a fork, the
    ring wrapping while it decodes; B1 launched 7 a recurrent block and 6
    (decode) or 8 (prefill) an attention block a pass."""
    from repro_torch.launch.serve import build_model
    from repro_torch.serving.generate import Request
    from repro_torch.serving.pages import tree_leaves
    from repro_torch.serving.state_engine import StatePagedEngine

    api, params = build_model(get_smoke("recurrentgemma_9b"), device="cuda")
    prompts = [np.random.default_rng(i).integers(0, 512, n) for i, n in enumerate((12, 9, 30))]
    outs = []
    for graphs, depth in ((False, 1), (True, 2)):
        build.reset_counts()
        eng = StatePagedEngine(api, params, n_slots=4, max_len=64, page_size=8,
                               pipeline_depth=depth, cuda_graphs=graphs)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=25, n_samples=2 if i == 1 else 1))
        for _ in range(5):
            eng.step()
        eng._preempt_one(None)
        fin, _ = eng.run_to_completion()
        torch.cuda.synchronize()
        st, cs = eng.stats, eng.health()["state_counters"]
        prefills = st["prefill_launches"] - cs["state_restores"]
        passes = st["decode_ticks"] + cs["replay_tokens"]
        # a pass of the 1-period smoke: 2 × 7 + 8 (prefill) or 2 × 7 + 6 (decode)
        assert build.counts().get("bcq_linear", 0) == 22 * prefills + 20 * passes
        outs.append(([(r.rid, r.sample_idx, r.out, r.margins) for r in
                      sorted(fin, key=lambda r: (r.rid, r.sample_idx))], cs,
                     [t.cpu() for t in tree_leaves(eng.live) + tree_leaves(eng.spool)]))
        if graphs:
            assert sorted(eng._graphs.buckets) == [False, True]
    (a, ca, ta), (b, cb_, tb) = outs
    assert a == b and ca == cb_
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert max(len(r[2]) for r in a) + 30 > 32  # a row decoded past the window


# whisper_base's linears: M 1500 (an encode, one 30 s clip) and M 8 (a decode
# tick of 8 slots) at d 512 → 512, 512 → 2048 and 2048 → 512
@pytest.mark.cuda
@pytest.mark.parametrize("kn", [(512, 512), (512, 2048), (2048, 512)],
                         ids=lambda kn: f"K{kn[0]}_N{kn[1]}")
@pytest.mark.parametrize("m", [1500, 8])
def test_bcq_linear_kernel_matches_plain_at_whisper_shapes(cuda, m, kn):
    k, n = kn
    x = _activation(m, k, m + k + n, cuda)
    pw, cb = _packed(n, k, 3 * n + k, cuda), _cb(cuda)
    s_x = bcq.tensor_scale(x, CFG)
    before = bcq_linear.BCQ_LINEAR.count
    got = bcq_linear.bcq_linear(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, s_x, CFG)
    want = fused_linear_ref(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, CFG, s_x, valid_k=k)
    assert got.shape == (m, n) and bcq_linear.BCQ_LINEAR.count == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_flash_kernel_matches_plain_at_whisper_evaluation_shape(cuda):
    """The enc-dec evaluation forward's decoder self-attention: 4 clips × 8
    heads, 448 tokens (Whisper's text context), head 64, bf16, causal."""
    g = torch.Generator().manual_seed(448)
    q, k, v = (torch.randn((32, 448, 64), generator=g).to(cuda, torch.bfloat16)
               for _ in range(3))
    before = flash.FLASH_ATTENTION.count
    got = flash.flash_attention_kernel(q, k, v, True)
    assert flash.FLASH_ATTENTION.count == before + 1
    want = flash.flash_attention_plain(q, k, v, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_encdec_state_decode_graph_equals_eager(cuda):
    """The smoke enc-dec (bcq4 self cache, encoder pages) through
    StatePagedEngine on the card: graph depth 2 ≡ eager depth 1 bit for bit
    (tokens, margins, counters, live tree, state and encoder pools) with
    requests over two frames (a prefix hit), a preemption and a fork; B1
    launched exactly 6 an encoder layer and 2 a decoder layer an encode (the
    cross K/V), 8 a decoder layer a pass."""
    from repro_torch.launch.serve import build_model
    from repro_torch.serving.generate import Request
    from repro_torch.serving.pages import tree_leaves
    from repro_torch.serving.state_engine import StatePagedEngine

    cfg = get_smoke("whisper_base")
    api, params = build_model(cfg, device="cuda")
    prompts = [np.random.default_rng(i).integers(0, 512, n) for i, n in enumerate((12, 9, 30))]
    frames = [(np.random.default_rng(10 + i).normal(size=(cfg.encoder_len, cfg.d_model)) * 0.02
               ).astype(np.float32) for i in range(2)]
    per_encode = 6 * cfg.n_encoder_layers + 2 * cfg.n_layers
    outs = []
    for graphs, depth in ((False, 1), (True, 2)):
        build.reset_counts()
        eng = StatePagedEngine(api, params, n_slots=4, max_len=64, page_size=8,
                               pipeline_depth=depth, cuda_graphs=graphs)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=25, n_samples=2 if i == 1 else 1,
                               frames=frames[i % 2]))
        for _ in range(5):
            eng.step()
        eng._preempt_one(None)
        fin, _ = eng.run_to_completion()
        torch.cuda.synchronize()
        st, cs = eng.stats, eng.health()["state_counters"]
        prefills = st["prefill_launches"] - cs["state_restores"]
        passes = prefills + st["decode_ticks"] + cs["replay_tokens"]
        assert cs["encoder_launches"] == 2 and st["prefix_hits"] == 1
        assert build.counts().get("bcq_linear", 0) == (
            per_encode * cs["encoder_launches"] + 8 * cfg.n_layers * passes)
        outs.append(([(r.rid, r.sample_idx, r.out, r.margins) for r in
                      sorted(fin, key=lambda r: (r.rid, r.sample_idx))], cs,
                     [t.cpu() for t in tree_leaves(eng.live) + tree_leaves(eng.spool)]
                     + [t.cpu() for t in eng.enc_pool]))
        if graphs:
            assert sorted(eng._graphs.buckets) == [False, True]
        assert eng.audit().ok
    (a, ca, ta), (b, cb_, tb) = outs
    assert a == b and ca == cb_
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))


# ------------------------------------------- trained (non-integer) codebooks
def _trained_books(device, steps=3, lr=1e-3, seed=0):
    """The universal codebooks after a few Adam-sized steps: every level
    moved by ±lr a step (sorted, no longer integers), as W4A4 fake-quant
    training leaves them."""
    g = torch.Generator().manual_seed(seed)
    cb = _cb("cpu")
    for _ in range(steps):
        cb = cb + lr * torch.sign(torch.randn(cb.shape, generator=g))
    return torch.sort(cb, dim=-1).values.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mk", [(8192, 768), (8192, 3072), (256, 768), (37, 192)])
def test_bcq_quantize_threshold_search_on_trained_books(cuda, mk):
    """B3 widened to any sorted f32 codebooks: on trained books it takes its
    threshold search (one launch, counted on both counters) and equals
    ``quantize_ref``: ratios and decoded values bit for bit, indices and
    selectors but on codebook ties."""
    m, k = mk
    x, cb = _activation(m, k, 5 * m + k, cuda), _trained_books(cuda)
    assert not bcq.check_kernel_codebooks(cb, CFG, integer=False)
    s_x = bcq.tensor_scale(x, CFG)
    before = (bcq_quantize.BCQ_QUANTIZE.count, bcq_quantize.BCQ_QUANTIZE_THR.count)
    idx, sel, ratio = bcq_quantize.bcq_quantize(x, cb, s_x, CFG)
    assert (bcq_quantize.BCQ_QUANTIZE.count, bcq_quantize.BCQ_QUANTIZE_THR.count) == (
        before[0] + 1, before[1] + 1)
    r_idx, r_sel, r_ratio = quantize_ref(x, cb, CFG, s_x)
    assert torch.equal(ratio, r_ratio)
    inv = 1.0 / (r_ratio * s_x)
    assert torch.equal(decode_ref(idx, sel, inv, cb, CFG), decode_ref(r_idx, r_sel, inv, cb, CFG))
    ties = int((idx != r_idx).sum()) + int((sel != r_sel).sum())
    assert ties <= m * k // 1000  # ties are rare on trained books


@pytest.mark.cuda
def test_bcq_quantize_integer_books_keep_the_table(cuda):
    """Integer books take the table (the threshold counter stays), with the
    bytes of ``quantize_ref``; the threshold search's C entry on the same
    integer books writes the same bytes as the table."""
    m, k = 8192, 768
    x, cb = _activation(m, k, 11, cuda), _cb(cuda)
    s_x = bcq.tensor_scale(x, CFG)
    thr_before = bcq_quantize.BCQ_QUANTIZE_THR.count
    idx, sel, ratio = bcq_quantize.bcq_quantize(x, cb, s_x, CFG)
    assert bcq_quantize.BCQ_QUANTIZE_THR.count == thr_before
    r_idx, r_sel, r_ratio = quantize_ref(x, cb, CFG, s_x)
    assert torch.equal(ratio, r_ratio) and torch.equal(idx, r_idx) and torch.equal(sel, r_sel)
    outs = [torch.empty_like(t) for t in (idx, sel, ratio)]
    status = build.library().bcq_quantize_thr_launch(
        x.data_ptr(), cb.data_ptr(), s_x.data_ptr(), *(t.data_ptr() for t in outs), m, k,
        CFG.codeword_max, *build.format_args(CFG), 1,
        torch.cuda.current_stream(cuda).cuda_stream)
    build.check(status, "bcq_quantize_thr_launch")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, (idx, sel, ratio)))


@pytest.mark.cuda
def test_fake_quant_kernel_route_gradients_equal_plain(cuda, monkeypatch):
    """W4A4 fake-quant training's loss and gradient (codebooks included)
    through B3's route equal the plain route's bit for bit, on integer
    books and on trained books: B3's outputs are constants of the graph,
    the torch decode carries the gradient to s_X and the codebooks."""
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    cfg = get_smoke("gpt3_126m")
    api = zoo.build(cfg, Runtime(quant_mode="fake", compute_dtype=torch.float32), device=cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (4, 65))).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for books in ("integer", "trained"):
        params = api.init_train(0)
        if books == "trained":
            params["codebooks"] = _trained_books(cuda)
        runs = []
        for route in ("kernel", "plain"):
            if route == "plain":
                monkeypatch.setattr(bcq, "fake_quant", bcq.fake_quant_plain)
            build.reset_counts()
            with train.deterministic():
                loss, grads = train.value_and_grad(api.loss_fn, params, batch)
            torch.cuda.synchronize()
            runs.append((loss, grads, build.counts().get("bcq_quantize", 0)))
            monkeypatch.undo()
        (lk, gk, nk), (lp, gp, np_) = runs
        assert nk == 4 * cfg.n_layers and np_ == 0
        assert torch.equal(lk, lp)
        assert float(gk["codebooks"].abs().max()) > 0
        for a, b in zip(train.adamw.tree_leaves(gk), train.adamw.tree_leaves(gp)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_integer_premise_kernels_refuse_trained_books(cuda):
    """B1, B4 and the KV-page writer multiply int8 codes: on trained books
    they raise the message they always gave; the flash kernel refuses
    inputs that require grad on the card."""
    cb = _trained_books(cuda)
    x = _activation(8, 768, 3, cuda)
    s_x = bcq.tensor_scale(x, CFG)
    pw = _packed(64, 768, 4, cuda)
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        bcq_linear.bcq_linear(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, s_x, CFG)
    a_idx, a_sel, ratio = quantize_ref(x, _cb(cuda), CFG, s_x)
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        bcq_matmul.bcq_matmul(a_idx, a_sel, 1.0 / (ratio * s_x), pw.idx_packed, pw.sel_packed,
                              pw.inv_scale, cb, cb, CFG)
    kv = torch.zeros((2, 1, 2, 64), device=cuda)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        bcq_quantize.bcq_page_write({}, kv, kv, CFG, cb, page_ids=ids, offsets=ids)
    q = torch.zeros((2, 64, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        flash.flash_attention_kernel(q, q, q)


# ------------------------------------------------------------ the model zoo
# the GQA groups of the dense zoo's pages: Qwen2-0.5B 14/2, StarCoder2-3B
# 24/2, Phi-3-medium 40/10, Qwen1.5-32B 40/40 (MHA) — query groups of 7,
# 12, 4 and 1 over one KV head — each at d_head 64 and 128
ZOO_HEADS = [(14, 2), (24, 2), (40, 10), (40, 40)]


def _zoo_gather_case(kind, c, h, hkv, d, cuda):
    """Rows over several splits (lengths on and past a split edge, a
    zero-length row, a full table), NULL past each row's live pages; at
    C > 1 each row's chunk is its last C positions (causal)."""
    ps = 16
    sp = common.SPLIT_PAGES
    maxp = 2 * sp + 3
    n_pages = maxp + 5
    g = torch.Generator().manual_seed(h * d + hkv + c)
    pool = layers.cache_init(n_pages, ps, hkv, d, kind, CFG, device=cuda)
    kv = [torch.randn((n_pages, ps, hkv, d), generator=g).to(cuda) for _ in range(2)]
    for name, val in layers.cache_encode(*kv, kind, CFG, _cb(cuda), pool).items():
        pool[name].copy_(val)
    kv_len = [0, 5, sp * ps, sp * ps + 3, maxp * ps - 7, maxp * ps]
    if c > 1:
        kv_len = [0] + [max(n, c) for n in kv_len[1:]]
    bt = torch.randint(1, n_pages, (len(kv_len), maxp), generator=g, dtype=torch.int32)
    for r, n in enumerate(kv_len):
        bt[r, -(-n // ps):] = 0
    q = torch.randn((len(kv_len), c, h, d), generator=g).to(cuda)
    return (q, pool, bt.to(cuda), torch.tensor(kv_len, dtype=torch.int32, device=cuda), kind,
            CFG, _cb(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 64])
@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hkv", ZOO_HEADS, ids=lambda v: str(v))
def test_page_gather_zoo_query_groups_match_plain(cuda, h, hkv, d, kind, c):
    """B2's GQA arm at the zoo's query groups (idle query slots of a
    z-block masked, the combine indexed per query head), at decode and a
    64-token chunk."""
    args = _zoo_gather_case(kind, c, h, hkv, d, cuda)
    got = common.page_gather_attention(*args)
    want = common.page_gather_attention_plain(*args)
    assert got.shape == args[0].shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv", [2, 10, 40])
@pytest.mark.parametrize("c", [1, 64])
def test_page_write_kernel_matches_plain_at_the_zoo_heads(cuda, c, hkv, d):
    """The KV-page writer at the zoo's KV head counts, byte for byte
    against the plain writer; layers 0 and 2 stay untouched."""
    stacked, k, v, kw = _kv_write_case(c, d, hkv, torch.float32, cuda, seed=c + hkv + d)
    before = {n: t.clone() for n, t in stacked.items()}
    pool = {n: t[1] for n, t in stacked.items()}
    plain = {n: t[1].clone() for n, t in stacked.items()}
    cb = _cb(cuda)
    bcq_quantize.bcq_page_write(pool, k, v, CFG, cb, **kw)
    _layers_write(plain, k, v, cb, kw, kernel=False)
    for n in stacked:
        assert torch.equal(pool[n], plain[n]), n
        assert torch.equal(stacked[n][0], before[n][0]) and torch.equal(stacked[n][2], before[n][2])


# Qwen2-0.5B's K/V projection (K 896 = 14 arrays, N 128), StarCoder2-3B's
# (3072 → 256), Qwen1.5-32B's MLP in at a 512-row prefill chunk
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 896, 128), (8, 3072, 256), (512, 5120, 27392)])
def test_bcq_linear_at_the_zoo_shapes(cuda, m, k, n):
    g = torch.Generator().manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=g) * 3.0).to(cuda)
    w = (torch.randn((k, n), generator=g) * k**-0.5).to(cuda)
    cb = _cb(cuda)
    # ``layers.pack_weight``'s bytes, encoded 4,096 rows at a time with the
    # whole weight's s_X: its plain encode of 27392 × 5120 at once holds
    # ~30 GB of per-codebook intermediates
    wt = w.T.contiguous()
    s_w = bcq.tensor_scale(wt, CFG)
    encs = [bcq.encode(wt[i:i + 4096], cb, CFG, s_x=s_w) for i in range(0, n, 4096)]
    pw = ops.packed_operand({"idx": torch.cat([e.packed_idx for e in encs]),
                             "sel": torch.cat([e.packed_sel for e in encs]),
                             "scale": torch.cat([e.scale_code for e in encs]), "s_x": s_w})
    if n <= 4096:
        whole = layers.pack_weight(w, CFG, cb)
        assert torch.equal(whole["idx"], pw.idx_packed) and torch.equal(whole["sel"], pw.sel_packed)
    s_x = bcq.tensor_scale(x, CFG)
    got = bcq_linear.bcq_linear(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, s_x, CFG)
    want = fused_linear_ref(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, CFG, s_x, valid_k=k)
    assert got.shape == (m, n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    del got, want, pw, encs, wt, w, x
    torch.cuda.empty_cache()  # the plain version at 512 × 5120 → 27392 cached ~26 GB


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2_3b", "phi3_medium_14b", "qwen1_5_32b"])
def test_zoo_smoke_engine_through_the_kernels(cuda, arch, monkeypatch):
    """Each dense zoo smoke through ``PagedEngine`` on the card: exact launch
    counts at graph depth 2, none in the plain run, and every B1, B2 and
    writer launch of an eager kernel run held to its plain version on its
    own inputs (a whole-run token comparison cannot hold random smoke
    weights: one W4A4 flip from B1's f32 sum order moves every later
    launch).  The Qwen2 smoke's d_model 112 is not whole 64-wide arrays,
    which B1 refuses; Qwen2 runs at full width (d_model 896) in
    ``chip_smoke.py``'s model-zoo phase."""
    from repro_torch.kernels import chunked_prefill, paged_attention

    cfg = get_smoke(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (9, 21, 40)]
    kw = dict(cache="bcq4", packed=True, page_size=8, prefill_chunk=16, device=cuda,
              chunked_prefill=True, prefix_caching=False)
    build.reset_counts()
    _, eng = serve(cfg, prompts, 8, **kw)
    torch.cuda.synchronize()
    counts = build.counts()
    passes = eng.stats["decode_ticks"] + eng.stats["prefill_launches"]
    per = 7 if cfg.act == "swiglu" else 6
    assert counts["bcq_linear"] == per * cfg.n_layers * passes
    assert counts["page_gather"] == counts["bcq_page_write"] == cfg.n_layers * passes
    build.reset_counts()
    serve(cfg, prompts, 8, kernels=False, pipeline_depth=1, cuda_graphs=False, **kw)
    assert not any(build.counts().get(n) for n in ("bcq_linear", "page_gather", "bcq_page_write"))

    held = {"bcq_linear": 0, "page_gather": 0, "bcq_page_write": 0}
    real_lin = ops.bcq_linear

    def lin(x, w_idx, w_sel, w_inv, cb, s_x, bcfg):
        out = real_lin(x, w_idx, w_sel, w_inv, cb, s_x, bcfg)
        want = fused_linear_ref(x, w_idx, w_sel, w_inv, cb, bcfg, s_x, valid_k=x.shape[1])
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
        held["bcq_linear"] += 1
        return out

    def gather(real):
        def run(q, pool, bt, kv_len, kind, bcfg, cb=None):
            out = real(q, pool, bt, kv_len, kind, bcfg, cb)
            want = common.page_gather_attention_plain(q, pool, bt, kv_len, kind, bcfg, cb)
            torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
            held["page_gather"] += 1
            return out
        return run

    def write(real):
        def run(pool, *args, **kwargs):
            plain = {n: t.clone() for n, t in pool.items()}
            out = real(pool, *args, **kwargs)
            real(plain, *args, **dict(kwargs, kernel=False))
            assert all(torch.equal(out[n], plain[n]) for n in out)
            held["bcq_page_write"] += 1
            return out
        return run

    monkeypatch.setattr(ops, "bcq_linear", lin)
    monkeypatch.setattr(paged_attention, "page_gather_attention",
                        gather(paged_attention.page_gather_attention))
    monkeypatch.setattr(chunked_prefill, "page_gather_attention",
                        gather(chunked_prefill.page_gather_attention))
    monkeypatch.setattr(layers, "paged_token_write", write(layers.paged_token_write))
    monkeypatch.setattr(layers, "paged_chunk_write", write(layers.paged_chunk_write))
    _, eng = serve(cfg, prompts, 8, pipeline_depth=1, cuda_graphs=False, **kw)
    passes = eng.stats["decode_ticks"] + eng.stats["prefill_launches"]
    assert held == {"bcq_linear": per * cfg.n_layers * passes,
                    "page_gather": cfg.n_layers * passes, "bcq_page_write": cfg.n_layers * passes}
