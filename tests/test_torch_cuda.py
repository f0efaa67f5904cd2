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
where a block ties between codebooks) and ratios exactly equal;
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
def test_flash_gqa_wrapper_matches_plain(cuda):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 256, 8, 64), generator=g).to(cuda)
    k, v = (torch.randn((2, 256, 2, 64), generator=g).to(cuda) for _ in range(2))
    got = flash.flash_attention(q, k, v)
    want = layers._attend_chunked(q, k, v, torch.arange(256, device=cuda)[None].expand(2, 256), 256)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
@pytest.mark.parametrize("c,d,h,hkv", [(1, 64, 12, 12), (8, 32, 4, 2)])
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
    fin_k, eng = serve(cfg, prompts, 6, page_size=8, prefill_chunk=16, device=cuda, kernels=True)
    counts = build.counts()
    fin_p, _ = serve(cfg, prompts, 6, page_size=8, prefill_chunk=16, device=cuda, kernels=False)
    passes = eng.stats["decode_ticks"] + eng.stats["prefill_launches"]
    assert counts["bcq_linear"] == cfg.n_layers * 6 * passes
    assert counts["page_gather"] == cfg.n_layers * passes
    agree = greedy_agreement({r.rid: r for r in fin_p}, {r.rid: r for r in fin_k}, 1e-3)
    assert agree["ok"], agree
