"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and a smoke-size serving run through the kernels against the
plain paths.  Marked ``cuda``; each test decides inside its fixture
whether a card is present and skips here otherwise (a CUDA kernel has no
interpret mode).  Run on the card with::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py

Tolerances: fused linear ``rtol=1e-5, atol=1e-5·max|plain|`` (the encode
is bit-identical, the f32 sum order over K differs); page-gather
``atol=rtol=2e-5`` (softmax and accumulation order differ); serving
tokens equal under the margin rule with a 1e-3 logit tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke
from repro_torch.core import bcq
from repro_torch.core.calibrate import default_universal_codebooks
from repro_torch.kernels import bcq_linear, build, common, ops
from repro_torch.kernels.ref import fused_linear_ref
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


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(8, 768, 3072), (256, 3072, 768), (37, 192, 100)])
def test_bcq_linear_kernel_matches_plain(cuda, mkn):
    m, k, n = mkn
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
