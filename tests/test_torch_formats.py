"""Port parity at the LO-BCQ formats beyond the default, against the JAX
package on the CPU: the formats of the reference's own kernel tests
(``torch_formats.REF_KERNEL_FORMATS``: g64/Lb8/Nc8, g128/Lb8/Nc16,
g32/Lb4/Nc4, g16/Lb2/Nc2, g64/Lb8/Nc16), Table 5's W3/W2 and Table 10's
INT4/INT6/INT8 codewords.  Held here, each tolerance with its reason:

* the port's plain B3 (``ref.quantize_ref``) against the reference's
  Pallas kernel in interpret mode, on the reference tests' kinds of
  operand and dtypes: the E4M3 ratios exactly equal, idx / sel bytes
  equal — or, where a block's two best codebooks (near-)tie, the
  reference test's own contract (tests/test_kernels.py:3-6, 67-74): each
  block's error within rtol 1e-4, under 1e-3 of the decoded values
  different (XLA may contract a block's squared-error sum into an FMA,
  which moves a near-tie: two-scalar blocks of bf16 inputs meet it);
* the port's plain B4 (``ref.matmul_ref``) and B1 (``ref.fused_linear_ref``)
  against the reference's Pallas GEMM and fused linear (interpret):
  ``rtol = 1e-5, atol = 1e-5·max|ref|`` (both decode bit-identically;
  only the f32 sum order over K differs);
* ``bcq.fake_quant_plain`` against ``repro.core.bcq.fake_quant``: equal;
* the port's plain bcq4 page read (``page_gather_attention_plain``) and
  plain page writes against the reference's ``page_gather_attention``
  (interpret) and ``paged_token_write`` / ``paged_chunk_write`` at
  g32/Lb4/Nc4 and g128/Lb8/Nc16 (L_A shrunk to 64 at d_head 64):
  ``atol = rtol = 2e-5`` (softmax and sum order), pool bytes equal;
* the 2-layer smoke ``gpt3_126m`` in packed W4A4 with bcq4 pages at
  g32/Lb4/Nc4 served through both packages' ``PagedEngine``: tokens
  equal under the margin rule (``TOL`` 1e-3, as tests/test_torch_engine.py);
* ``launch.quantize --device cpu --smoke --array-len 32 --n-codebooks 4``
  writing the reference's ``quantize_checkpoint`` artifacts: codebooks,
  npz arrays and sidecars, manifest equal (the fit history within
  ``HIST_RTOL``, f32 sums in another order).

Codebooks: integer levels fitted once per format by the port's
``fit_lobcq`` on a Laplace operand (4 iterations; the port's fit equals
the reference's, tests/test_torch_ptq.py) and given to both packages.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_formats import PAPER_FORMATS, REF_KERNEL_FORMATS, fitted_levels, fmt, tag
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke  # noqa: E402
from repro.core import bcq as jbcq  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels.bcq_linear import bcq_linear_pallas  # noqa: E402
from repro.kernels.bcq_matmul import bcq_matmul_pallas  # noqa: E402
from repro.kernels.bcq_quantize import bcq_quantize_pallas  # noqa: E402
from repro.launch import quantize as jquant  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro.serving.engine import PagedEngine as JEngine  # noqa: E402
from repro.serving.generate import Request as JRequest  # noqa: E402
from repro_torch.checkpoint import manager as tckpt  # noqa: E402
from repro_torch.configs.base import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.core import bcq as tbcq  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import quantize as tquant  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import zoo as tzoo  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402
from repro_torch.serving.engine import PagedEngine  # noqa: E402
from repro_torch.serving.generate import Request, greedy_agreement  # noqa: E402

M, K, N = 64, 256, 64  # one (64, 256) tile: every format's L_A and 2·L_b divide it
TILES = dict(tile_m=64, tile_k=256)
TOL = 1e-3
HIST_RTOL = 2e-4
_LEVELS = {}


def _jcfg(cfg):
    return jbcq.BCQConfig(block_len=cfg.block_len, array_len=cfg.array_len,
                          n_codebooks=cfg.n_codebooks, index_bits=cfg.index_bits,
                          codeword_bits=cfg.codeword_bits)


def _levels(cfg):
    """The format's integer codebooks (float32 numpy), fitted once."""
    if tag(cfg) not in _LEVELS:
        data = np.random.default_rng(0).laplace(size=60000).astype(np.float32)
        _LEVELS[tag(cfg)] = np.asarray(fitted_levels(cfg, torch.from_numpy(data)), np.float32)
    return _LEVELS[tag(cfg)]


def _operand(shape, kind, seed):
    """The reference kernel tests' kinds of operand, from numpy."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.standard_normal(shape)
    elif kind == "heavy":
        x = rng.standard_t(3.0, shape)
    else:  # outlier
        x = rng.standard_normal(shape)
        x = np.where(rng.random(shape) < 0.005, x * 40.0, x)
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


FORMATS = pytest.mark.parametrize("cfg", REF_KERNEL_FORMATS, ids=tag)


# ------------------------------------------------------------ B3, B4, B1
@FORMATS
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "heavy", "outlier"])
def test_plain_quantize_matches_the_pallas_kernel(cfg, dtype, kind):
    jc, cb = _jcfg(cfg), _levels(cfg)
    x = jnp.asarray(_operand((M, K), kind, 7)).astype(getattr(jnp, dtype)).astype(jnp.float32)
    s_x = jbcq.tensor_scale(x, jc)
    ip, sp, rt = bcq_quantize_pallas(x, jnp.asarray(cb), s_x, jc, interpret=True, **TILES)
    tc, tcb, ts = cfg, _t(cb), _t(s_x)
    idx, sel, ratio = tref.quantize_ref(_t(x), tcb, tc, ts)
    np.testing.assert_array_equal(ratio.numpy(), np.asarray(rt))
    if not (np.array_equal(idx.numpy(), np.asarray(ip))
            and np.array_equal(sel.numpy(), np.asarray(sp))):  # codebook (near-)ties
        inv = 1.0 / (ratio * ts)
        d1 = tref.decode_ref(idx, sel, inv, tcb, tc).numpy()
        d2 = tref.decode_ref(_t(ip), _t(sp), inv, tcb, tc).numpy()
        xf = np.asarray(x)
        e1 = ((d1 - xf) ** 2).reshape(-1, cfg.block_len).sum(-1)
        e2 = ((d2 - xf) ** 2).reshape(-1, cfg.block_len).sum(-1)
        np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-7)
        assert (d1 != d2).mean() < 1e-3


@FORMATS
def test_plain_matmul_and_linear_match_the_pallas_kernels(cfg):
    jc, cb = _jcfg(cfg), jnp.asarray(_levels(cfg))
    x = jnp.asarray(_operand((M, K), "normal", 1))
    w = jnp.asarray(_operand((N, K), "heavy", 2))
    a_sx, w_sx = jbcq.tensor_scale(x, jc), jbcq.tensor_scale(w, jc)
    packed = []
    for v, s in ((x, a_sx), (w, w_sx)):
        ip, sp, rt = bcq_quantize_pallas(v, cb, s, jc, interpret=True, **TILES)
        packed.append((ip, sp, 1.0 / (rt * s)))
    (a_idx, a_sel, a_inv), (w_idx, w_sel, w_inv) = packed
    want = bcq_matmul_pallas(a_idx, a_sel, a_inv, w_idx, w_sel, w_inv, cb, cb, jc,
                             tile_m=64, tile_n=64, tile_k=256, interpret=True)
    tcb = _t(cb)
    got = tref.matmul_ref(*(_t(t) for t in packed[0]), *(_t(t) for t in packed[1]), tcb, tcb, cfg)
    _close(got.numpy(), want)
    want = bcq_linear_pallas(x, w_idx, w_sel, w_inv, cb, a_sx, jc, tile_m=64, tile_n=64,
                             tile_k=256, interpret=True)
    got = tref.fused_linear_ref(_t(x), _t(w_idx), _t(w_sel), _t(w_inv), tcb, cfg, _t(a_sx),
                                valid_k=K)
    _close(got.numpy(), want)


@pytest.mark.parametrize("cfg", [c for c in PAPER_FORMATS
                                 if c.array_len == 128 and c.n_codebooks != 16], ids=tag)
def test_fake_quant_plain_matches_reference(cfg):
    """Table 5's W3/W2 and Table 10's INT4/INT6/INT8 codewords."""
    cb = _levels(cfg)
    for i, kind in enumerate(("normal", "heavy", "outlier")):
        x = _operand((48, 640), kind, 20 + i)  # 5 arrays of 128
        got = tbcq.fake_quant_plain(_t(x), _t(cb), cfg).numpy()
        want = np.asarray(jbcq.fake_quant(jnp.asarray(x), jnp.asarray(cb), _jcfg(cfg)))
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ B2 and the writer
PAGE_FORMATS = pytest.mark.parametrize("cfg", [fmt(4, 32, 4), fmt(8, 128, 16)], ids=tag)


def _pools(cfg, d, n_pages, ps, h, seed):
    """The same single-layer bcq4 pool in both packages: every slot written
    from seeded K/V by the reference's ``cache_write`` (the pool as a
    cache of P rows); v_sx 0.37."""
    rng = np.random.default_rng(seed)
    jc, cb = _jcfg(cfg), jnp.asarray(_levels(cfg))
    jpool = dict(jlayers.cache_init(n_pages, ps, h, d, "bcq4", jc))
    jpool["v_sx"] = jnp.float32(0.37)
    k = jnp.asarray(rng.standard_normal((n_pages, ps, h, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_t(3.0, (n_pages, ps, h, d)).astype(np.float32))
    jpool = dict(jlayers.cache_write(jpool, k, v, 0, "bcq4", jc, cb))
    return jpool, {n: _t(a) for n, a in jpool.items()}


@PAGE_FORMATS
@pytest.mark.parametrize("c", [1, 8])
def test_plain_bcq4_page_read_matches_reference(cfg, c):
    d, h, hkv, ps, n_pages, maxp = 64, 4, 2, 8, 9, 4
    jpool, tpool = _pools(cfg, d, n_pages, ps, hkv, c)
    rng = np.random.default_rng(c + 1)
    kv_len = np.array([0, ps, 2 * ps + 3, maxp * ps] if c == 1 else [c, ps + c, c, maxp * ps],
                      np.int32)
    bt = rng.integers(1, n_pages, (4, maxp)).astype(np.int32)
    for r, n in enumerate(kv_len):
        bt[r, -(-n // ps):] = 0
    q = rng.standard_normal((4, c, h, d)).astype(np.float32)
    cb = _levels(cfg)
    want = jcommon.page_gather_attention(jnp.asarray(q), jpool, jnp.asarray(bt), jnp.asarray(kv_len),
                                         "bcq4", _jcfg(cfg), jnp.asarray(cb), interpret=True)
    got = tcommon.page_gather_attention_plain(_t(q), tpool, _t(bt), _t(kv_len), "bcq4", cfg, _t(cb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@PAGE_FORMATS
@pytest.mark.parametrize("chunk", [False, True], ids=["token", "chunk"])
def test_plain_page_write_matches_reference(cfg, chunk):
    d, h, ps, n_pages = 64, 2, 8, 11
    jpool, tpool = _pools(cfg, d, n_pages, ps, h, 3)
    rng = np.random.default_rng(4)
    c = 20 if chunk else 1
    b = 4 if chunk else 8
    k = (rng.standard_normal((b, c, h, d)) * 1.5).astype(np.float32)
    v = rng.standard_t(3.0, (b, c, h, d)).astype(np.float32)
    jc, cb = _jcfg(cfg), _levels(cfg)
    if chunk:
        ids = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 0], [0, 0, 0]], np.int32)
        clen = np.array([20, 13, 9, 0], np.int32)
        want = jlayers.paged_chunk_write(jpool, jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids),
                                         "bcq4", jc, jnp.asarray(cb), jnp.asarray(clen))
        got = tlayers.paged_chunk_write(tpool, _t(k), _t(v), _t(ids), "bcq4", cfg, _t(cb),
                                        _t(clen), kernel=False)
    else:
        ids = np.array([3, 1, 3, 0, 5, 0, 6, 0], np.int32)
        off = np.array([2, 7, 5, 0, 0, 0, 3, 0], np.int32)
        want = jlayers.paged_token_write(jpool, jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids),
                                         jnp.asarray(off), "bcq4", jc, jnp.asarray(cb))
        got = tlayers.paged_token_write(tpool, _t(k), _t(v), _t(ids), _t(off), "bcq4", cfg,
                                        _t(cb), kernel=False)
    for n, leaf in want.items():
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(leaf), err_msg=n)


# --------------------------------------------- the smoke model at g32/Lb4/Nc4
G32 = fmt(4, 32, 4)
ENGINE = dict(n_slots=4, max_len=64, page_size=8, prefill_chunk=16, chunked_prefill=True,
              prefix_caching=False, pipeline_depth=1)
PLENS, BUDGETS = (5, 37, 12, 20), (2, 8, 5, 3)


@pytest.fixture(scope="module")
def dense():
    """The smoke gpt3_126m's float params (one jax.random draw) in both
    packages."""
    cfg = get_smoke("gpt3_126m")
    rt = JRuntime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32)
    params = jzoo.build(cfg, rt).init(jax.random.PRNGKey(0))
    return SimpleNamespace(cfg=cfg, params=params,
                           tparams=from_numpy_tree(jax.tree.map(np.asarray, params)))


def test_smoke_model_at_g32_serves_like_the_reference_engine(dense):
    """Packed W4A4 weights and bcq4 pages in g32/Lb4/Nc4: the reference's
    engine (its fused linear) and the port's, chunked prefill at depth 1,
    the same requests; tokens under the margin rule, every page returned."""
    cb = jnp.asarray(_levels(G32))
    packed = jptq.pack_params(dense.params, cb, _jcfg(G32))
    packed["codebooks"] = cb
    jrt = JRuntime(quant_mode="packed", bcq_cfg=_jcfg(G32), compute_dtype=jnp.float32,
                   param_dtype=jnp.float32, cache_kind="bcq4", paged_kernel=False,
                   fused_linear=True)
    prompts = [np.random.default_rng(0).integers(0, dense.cfg.vocab, n) for n in PLENS]
    jeng = JEngine(jzoo.build(dense.cfg, jrt), packed, **ENGINE)
    for i, (p, n) in enumerate(zip(prompts, BUDGETS)):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=n))
    jfin, jticks = jeng.run_to_completion()
    trt = TRuntime(quant_mode="packed", bcq_cfg=G32, compute_dtype=torch.float32,
                   cache_kind="bcq4", paged_kernel=True)
    teng = PagedEngine(tzoo.build(t_get_smoke("gpt3_126m"), trt, device="cpu"),
                       from_numpy_tree(jax.tree.map(np.asarray, packed)), device="cpu", **ENGINE)
    for i, (p, n) in enumerate(zip(prompts, BUDGETS)):
        teng.submit(Request(rid=i, prompt=p, max_new=n))
    tfin, ticks = teng.run_to_completion()
    assert ticks == jticks
    got = {r.rid: r for r in tfin}
    want = {r.rid: SimpleNamespace(out=list(r.out), margins=got[r.rid].margins,
                                   launch_ids=got[r.rid].launch_ids) for r in jfin}
    agree = greedy_agreement(want, got, TOL)
    assert agree["ok"], agree
    assert agree["equal_tokens"] > 0 and teng.pool_mgr.used() == 0


def test_quantize_cli_at_g32_nc4_writes_the_reference_artifacts(dense, tmp_path):
    """``main`` with ``--array-len 32 --n-codebooks 4`` on the CPU over a
    checkpoint of the reference's params, against the reference's
    ``quantize_checkpoint`` on the same params and calibration tokens."""
    from repro.data.pipeline import DataConfig, batch_at

    toks = np.array(batch_at(DataConfig(vocab=dense.cfg.vocab, seq_len=128, global_batch=4),
                             tquant.CALIB_STEP)["tokens"])
    jc = jbcq.BCQConfig(array_len=32, n_codebooks=4)
    jm = jquant.quantize_checkpoint(dense.params, dense.cfg, jc, str(tmp_path / "ref"),
                                    jnp.asarray(toks))
    tckpt.CheckpointManager(str(tmp_path / "ck")).save(1, {"params": dense.tparams},
                                                       blocking=True)
    tm = tquant.main(["--ckpt", str(tmp_path / "ck"), "--smoke", "--device", "cpu",
                      "--array-len", "32", "--n-codebooks", "4", "--out", str(tmp_path / "port")])
    assert tm == jm and tm["bcq"]["L_A"] == 32 and tm["bcq"]["N_c"] == 4
    jcb = json.loads((tmp_path / "ref" / "codebooks.json").read_text())
    tcb = json.loads((tmp_path / "port" / "codebooks.json").read_text())
    assert tcb["levels"] == jcb["levels"] and tcb["cfg"] == jcb["cfg"]
    np.testing.assert_allclose(tcb["history"], jcb["history"], rtol=HIST_RTOL)
    for name in ("weights_w4_fake.npz", "weights_w4_packed.npz"):
        with np.load(tmp_path / "ref" / name) as zj, np.load(tmp_path / "port" / name) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=f"{name} {k}")
                assert zt[k].dtype == zj[k].dtype
        assert ((tmp_path / "port" / f"{name}.json").read_text()
                == (tmp_path / "ref" / f"{name}.json").read_text())
    assert ((tmp_path / "port" / "manifest.json").read_text()
            == (tmp_path / "ref" / "manifest.json").read_text())
