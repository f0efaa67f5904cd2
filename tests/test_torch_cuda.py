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
        k, CFG.codeword_max, torch.cuda.current_stream(cuda).cuda_stream)
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
    non-integer book loads (the fake modes run it in plain torch) and every
    kernel that takes codebooks refuses it with the same message."""
    lv = default_universal_codebooks().levels.copy()
    lv[3, 5] += 0.5
    bad = bcq.CodebookSet(lv, CFG).as_tensor(cuda)
    x = _activation(8, 768, 3, cuda)
    s_x = bcq.tensor_scale(x, CFG)
    w = _packed(64, 768, 5, cuda)
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        bcq_quantize.bcq_quantize(x, bad, s_x, CFG)
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        bcq_linear.bcq_linear(x, w.idx_packed, w.sel_packed, w.inv_scale, bad, s_x, CFG)
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        bcq.fake_quant(x, bad, CFG)  # the B3 route: no silent plain fallback
    assert torch.isfinite(bcq.fake_quant_plain(x, bad, CFG)).all()


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
