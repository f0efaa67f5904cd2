"""Card-only tests of the kernels at every LO-BCQ format of the paper
(``torch_formats.PAPER_FORMATS``: Table 8's L_b × L_A × N_c ablation,
Table 5's W3/W2, Table 10's INT4/INT6/INT8 codewords and three more):
each kernel form against its plain version on the card.  Marked ``cuda``;
each test decides inside its fixture whether a card is present and skips
here otherwise.  Run on the card with::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_formats.py

Codebooks: integer ones fitted on the card by ``fit_lobcq`` (4
iterations, as the reference's kernel tests fit theirs) on a Laplace
operand.  Tolerances, as tests/test_torch_cuda.py: ``bcq.fake_quant``
equal to ``fake_quant_plain`` bit for bit; B3's bytes equal to
``quantize_ref``'s up to codebook ties (the decoded values equal) and
the ratios exactly; B1, B1s and B4 ``rtol=1e-5, atol=1e-5·max|plain|``
(each array's exact int32 sum is rescaled once, where the plain version
rounds every decoded value before an f32 dot); B1s equal to per-expert
B1 launches and the two W4A4 routes equal to each other bit for bit;
the page writer's pool bytes equal to the plain writer's; the page
gather ``atol=rtol=2e-5``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bcq
from repro_torch.kernels import bcq_linear, bcq_matmul, bcq_quantize, build, common, ops
from repro_torch.kernels.ref import (decode_ref, fused_linear_experts_ref, fused_linear_ref,
                                     matmul_ref, quantize_ref)
from repro_torch.models import layers
from torch_formats import PAPER_FORMATS, fitted_levels, tag

_BOOKS = {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _books(cfg, device):
    """Integer codebooks for ``cfg``, fitted once per format on the card."""
    if tag(cfg) not in _BOOKS:
        data = torch.from_numpy(np.random.default_rng(0).laplace(size=60000).astype(np.float32))
        _BOOKS[tag(cfg)] = fitted_levels(cfg, data.to(device))
    return torch.as_tensor(_BOOKS[tag(cfg)], dtype=torch.float32, device=device)


def _x(m, k, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    x[:, :: max(1, k // 8)] *= 12.0  # outlier channels
    return x.to(device)


def _w(n, k, cfg, cb, seed, device):
    w = (torch.randn((k, n), generator=torch.Generator().manual_seed(seed)) * k**-0.5).to(device)
    return ops.packed_operand(layers.pack_weight(w, cfg, cb))


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


FORMATS = pytest.mark.parametrize("cfg", PAPER_FORMATS, ids=tag)


@pytest.mark.cuda
@FORMATS
def test_fake_quant_kernel_route_bit_equal_plain(cuda, cfg):
    x, cb = _x(256, 1024, 3, cuda), _books(cfg, cuda)
    build.reset_counts()
    got = bcq.fake_quant(x, cb, cfg)
    counts = build.counts()
    assert counts["bcq_quantize"] == 1
    assert counts["bcq_quantize_thr"] == (0 if bcq.kernel_route(cfg).table else 1)
    assert torch.equal(got, bcq.fake_quant_plain(x, cb, cfg))


@pytest.mark.cuda
@FORMATS
@pytest.mark.parametrize("mk", [(64, 768), (37, 256)])
def test_quantize_kernel_matches_plain(cuda, cfg, mk):
    m, k = mk
    x, cb = _x(m, k, m + k, cuda), _books(cfg, cuda)
    s_x = bcq.tensor_scale(x, cfg)
    idx, sel, ratio = bcq_quantize.bcq_quantize(x, cb, s_x, cfg)
    r_idx, r_sel, r_ratio = quantize_ref(x, cb, cfg, s_x)
    assert torch.equal(ratio, r_ratio)
    if not (torch.equal(idx, r_idx) and torch.equal(sel, r_sel)):  # a codebook tie
        inv = 1.0 / (r_ratio * s_x)
        assert torch.equal(decode_ref(idx, sel, inv, cb, cfg), decode_ref(r_idx, r_sel, inv, cb, cfg))


@pytest.mark.cuda
@FORMATS
@pytest.mark.parametrize("m", [8, 16, 300])
def test_linear_and_matmul_kernels_match_plain(cuda, cfg, m):
    """B1 and B4 against their plain versions, and the two W4A4 routes
    (B1; B3 then B4) equal to each other bit for bit: the same codes, the
    same scales, the same fold order."""
    k, n = 768, 200
    x, cb = _x(m, k, 7 * m, cuda), _books(cfg, cuda)
    pw = _w(n, k, cfg, cb, m + 1, cuda)
    s_x = bcq.tensor_scale(x, cfg)
    build.reset_counts()
    fused = bcq_linear.bcq_linear(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, s_x, cfg)
    _close(fused, fused_linear_ref(x, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, cfg, s_x,
                                   valid_k=k))
    a = ops.quantize(x, cb, cfg, s_x=s_x)
    two = ops.matmul(a, pw, cb, cfg)
    _close(two, matmul_ref(a.idx_packed, a.sel_packed, a.inv_scale, pw.idx_packed,
                           pw.sel_packed, pw.inv_scale, cb, cb, cfg))
    assert build.counts()["bcq_linear"] == 1 and build.counts()["bcq_matmul"] == 1
    assert torch.equal(fused, two)


@pytest.mark.cuda
@FORMATS
@pytest.mark.parametrize("c", [1, 37])
def test_stacked_linear_equals_per_expert_launches(cuda, cfg, c):
    e, k, n = 4, 256, 96
    cb = _books(cfg, cuda)
    x = _x(e * c, k, c, cuda).reshape(e, c, k)
    ws = [_w(n, k, cfg, cb, 10 + i, cuda) for i in range(e)]
    idx, sel, inv = (torch.stack([getattr(w, f) for w in ws])
                     for f in ("idx_packed", "sel_packed", "inv_scale"))
    s_x = bcq.tensor_scale(x, cfg)
    got = bcq_linear.bcq_linear_experts(x, idx, sel, inv, cb, s_x, cfg)
    per = torch.stack([bcq_linear.bcq_linear(x[i], idx[i], sel[i], inv[i], cb, s_x, cfg)
                       for i in range(e)])
    assert torch.equal(got, per)
    _close(got, fused_linear_experts_ref(x, idx, sel, inv, cb, cfg, s_x))


def _pool(cfg, cb, d, h, n_pages, ps, seed, device):
    g = torch.Generator().manual_seed(seed)
    pool = layers.cache_init(n_pages, ps, h, d, "bcq4", cfg, device=device)
    k = torch.randn((n_pages, ps, h, d), generator=g).to(device)
    v = (torch.randn((n_pages, ps, h, d), generator=g) * 2.0).to(device)
    for name, val in layers.cache_encode(k, v, "bcq4", cfg, cb, pool).items():
        pool[name].copy_(val)
    return pool


@pytest.mark.cuda
@FORMATS
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("c", [1, 64])
def test_page_write_kernel_matches_plain(cuda, cfg, c, d):
    """The writer (L_A shrunk to d_head where the cache shrinks it) against
    the plain writer, byte for byte: decode rows on their slots, and a
    chunk over whole and ragged pages."""
    h, ps, b = 4, 16, 4
    cb = _books(cfg, cuda)
    pool = _pool(cfg, cb, d, h, 24, ps, c + d, cuda)
    plain = {n: t.clone() for n, t in pool.items()}
    g = torch.Generator().manual_seed(d)
    k = (torch.randn((b, c, h, d), generator=g) * 1.5).to(cuda)
    v = (torch.randn((b, c, h, d), generator=g) * 3.0).to(cuda)
    if c == 1:
        ids = torch.tensor([3, 1, 3, 7], device=cuda)
        off = torch.tensor([2, 15, 9, 0], dtype=torch.int32, device=cuda)
        bcq_quantize.bcq_page_write(pool, k, v, cfg, cb, page_ids=ids, offsets=off)
        layers.paged_token_write(plain, k, v, ids, off, "bcq4", cfg, cb, kernel=False)
    else:
        ids = torch.arange(1, 1 + b * 4, dtype=torch.int32).reshape(b, 4).to(cuda)
        clen = torch.tensor([c, c - 5, ps + 3, 0], dtype=torch.int32, device=cuda)
        bcq_quantize.bcq_page_write(pool, k, v, cfg, cb, chunk_page_ids=ids, chunk_len=clen)
        layers.paged_chunk_write(plain, k, v, ids, "bcq4", cfg, cb, clen, kernel=False)
    for n in pool:
        assert torch.equal(pool[n], plain[n]), n


@pytest.mark.cuda
@FORMATS
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("c", [1, 8])
def test_page_gather_bcq4_matches_plain(cuda, cfg, c, d):
    ps, n_pages, maxp, h = 8, 9, 4, 8
    cb = _books(cfg, cuda)
    pool = _pool(cfg, cb, d, 4, n_pages, ps, d, cuda)
    g = torch.Generator().manual_seed(c)
    kv_len = [0, ps, 2 * ps + 3, maxp * ps] if c == 1 else [c, ps + c, 0, maxp * ps]
    bt = torch.randint(1, n_pages, (4, maxp), generator=g, dtype=torch.int32)
    for r, n in enumerate(kv_len):
        bt[r, -(-n // ps):] = 0
    bt, kvl = bt.to(cuda), torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    q = torch.randn((4, c, h, d), generator=g).to(cuda)
    before = common.PAGE_GATHER.count
    got = common.page_gather_attention(q, pool, bt, kvl, "bcq4", cfg, cb)
    want = common.page_gather_attention_plain(q, pool, bt, kvl, "bcq4", cfg, cb)
    assert common.PAGE_GATHER.count == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mk", [(8, 768), (8192, 768), (37, 3072)])
def test_threshold_search_gives_the_table_bytes_at_the_default_format(cuda, mk):
    """Both threshold searches at the default format — the compiled one
    (SEARCH8, special 1) and the general one (special 0) — write the table
    path's bytes bit for bit on integer books."""
    cfg = bcq.BCQConfig()
    m, k = mk
    x, cb = _x(m, k, m, cuda), _books(cfg, cuda)
    s_x = bcq.tensor_scale(x, cfg)
    table = bcq_quantize.bcq_quantize(x, cb, s_x, cfg)
    for special in (1, 0):
        outs = [torch.empty_like(t) for t in table]
        build.check(build.library().bcq_quantize_thr_launch(
            x.data_ptr(), cb.data_ptr(), s_x.data_ptr(), *(t.data_ptr() for t in outs), m, k,
            cfg.codeword_max, *build.format_args(cfg), special,
            torch.cuda.current_stream(cuda).cuda_stream), "bcq_quantize_thr_launch")
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, table)), special


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [bcq.BCQConfig(n_codebooks=32), bcq.BCQConfig(index_bits=5),
                                 bcq.BCQConfig(block_len=16, array_len=64)],
                         ids=["Nc32", "B5", "Lb16"])
def test_a_format_outside_the_set_raises(cuda, cfg):
    x = _x(8, 256, 0, cuda)
    cb = torch.zeros((cfg.n_codebooks, cfg.n_entries), device=cuda)
    with pytest.raises(ValueError, match="CUDA kernels"):
        bcq_quantize.bcq_quantize(x, cb, bcq.tensor_scale(x, cfg), cfg)


@pytest.mark.cuda
def test_a_route_the_format_cannot_take_is_refused(cuda):
    """The C entries take their route from ``bcq.kernel_route`` and refuse,
    before any launch, one their format cannot take: the compiled paths
    outside the default format, the table past |codeword| 31."""
    lib, st = build.library(), torch.cuda.current_stream(cuda).cuda_stream
    g32 = build.format_args(bcq.BCQConfig(array_len=32, n_codebooks=4))
    dflt = build.format_args(bcq.BCQConfig())
    p = (None,) * 6
    assert lib.bcq_quantize_thr_launch(*p, 8, 256, 31.0, *g32, 1, st) != 0
    assert lib.bcq_matmul_launch(*p, None, None, None, 8, 64, 256, *g32, 1, st) != 0
    assert lib.bcq_linear_launch(*p, None, None, None, 8, 64, 256, 127.0, *dflt, 1, 1, st) != 0
    assert lib.bcq_linear_launch(*p, None, None, None, 8, 64, 256, 31.0, *g32, 0, 1, st) != 0
