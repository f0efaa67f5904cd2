"""The PTQ deploy step of the port against the JAX package: number formats,
the baseline quantizers, Lloyd-Max, the LO-BCQ fit, calibration, PTQ of a
parameter tree and checkpoint I/O (the quantize CLI is
``tests/test_torch_ptq_cli.py``, the model in the fake modes
``tests/test_torch_ptq_model.py``).

Inputs come from numpy seeds and go through both packages.  Held here:

* formats and baselines (MX4, MXFP4, VSQ, INT per tensor, EeMm per
  tensor) bit-equal, on inputs with zeros, an outlier and a whole block
  of zeros; ``lloydmax_pertensor`` within ``LLOYD_TOL``;
* Lloyd-Max: ``quantize_to_levels`` exact, ``quantile_init`` within
  ``LM_TOL`` and ``lloyd_max_batched`` / ``lloyd_max_1d`` within
  ``LLOYD_TOL`` (rtol, and atol relative to the largest level): the
  port's per-cluster sums add in another order than XLA's
  ``segment_sum``, and over many passes a last bit can move a scalar
  across a threshold;
* ``jax.random`` in torch: split, randint, permutation, uniform
  bit-equal; ``kmeanspp_seeds`` equal for one key;
* the fit: ``fit_lobcq`` (with and without the ``max_blocks`` subsample)
  and ``naive_init_fit`` give the reference's codebooks exactly, the
  history within ``HIST_RTOL`` and non-increasing (§A.2); a
  ``quantize_codewords=False`` fit within ``LLOYD_TOL``, it loads and runs in
  ``fake`` mode, and the kernels' premise refuses it;
* calibration: ``capture_gemm_inputs``' samples within 1e-6 relative,
  ``calibrate_from_model``'s codebooks equal;
* ptq: ``quantize_params`` values and ``encode_params`` bytes equal (the
  port's plain encode resolves codebook ties as the reference does),
  ``count_quantized_bits`` equal, the MoE stack included;
* checkpoints: npz written by either package load in the other (a bf16
  leaf is stored as 2-byte void with dtype ``bfloat16`` in the sidecar;
  the port loads it as ``torch.bfloat16``, the reference as the raw
  ``|V2`` array); retention, async writes, atomicity.

Regenerating the universal books points ``_CB_DIR`` at a temporary
directory: the committed file stays a byte copy of the reference's, as
the file's last test checks.
"""
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.core import baselines as tbase
from repro_torch.core import bcq as tbcq
from repro_torch.core import calibrate as tcal
from repro_torch.core import formats as tfmt
from repro_torch.core import lloyd_max as tlm
from repro_torch.core import ptq as tptq
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import prng
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = Path(__file__).resolve().parents[1]
CB_FILE = "configs/codebooks/universal_g64_Lb8_Nc8.json"
TC = tbcq.BCQConfig()
LM_TOL = 1e-5  # one Lloyd-Max pass, quantiles: f32 sums in another order
LLOYD_TOL = 1e-3  # many passes: a scalar a last bit moves across a threshold
HIST_RTOL = 2e-4  # the fit's MSE history of the unrounded levels
FIT_KW = dict(iters=4, lm_iters=6)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
    import jax.numpy as jnp

    from repro.checkpoint import manager as ckpt
    from repro.configs.base import get_smoke
    from repro.core import baselines, bcq, calibrate, formats, lloyd_max, ptq
    from repro.models import zoo
    from repro.models.layers import Runtime

    return SimpleNamespace(jax=jax, jnp=jnp, ckpt=ckpt, get_smoke=get_smoke, base=baselines,
                           bcq=bcq, cal=calibrate, fmt=formats, lm=lloyd_max, ptq=ptq,
                           zoo=zoo, Runtime=Runtime)


def _np(ref, tree):
    return ref.jax.tree.map(np.asarray, tree)


def _edge_input(seed, shape=(6, 200)):
    """Gaussian · 3 with zeros, an outlier and an all-zero 16-block."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    v = x.reshape(-1, shape[-1])
    v[0, :5] = 0.0
    v[1, shape[-1] // 4] = 400.0
    v[2, 16:32] = 0.0
    v[min(3, len(v) - 1), :] = 0.0
    return x


INPUTS = [_edge_input(0), _edge_input(1, (3, 2, 64)) * 1e-3]


# ------------------------------------------------------------------ formats
@pytest.mark.parametrize("name", ["INT4", "INT6", "INT8", "E4M3", "E5M2", "E2M1", "E1M2",
                                  "E3M0", "E3M2", "E3M3", "E8M0"])
def test_format_quantize_bit_equal(ref, name):
    jf, tf = ref.fmt.FORMATS[name], tfmt.FORMATS[name]
    assert jf.name == tf.name and jf.max_val == tf.max_val
    for x in INPUTS:
        np.testing.assert_array_equal(tf.quantize(torch.from_numpy(x)).numpy(),
                                      np.asarray(jf.quantize(ref.jnp.asarray(x))))
        if name != "E8M0":
            np.testing.assert_array_equal(tf.levels(), jf.levels())
            np.testing.assert_array_equal(
                tfmt.quantize_tensor_scaled(torch.from_numpy(x), tf, axis=-1).numpy(),
                np.asarray(ref.fmt.quantize_tensor_scaled(ref.jnp.asarray(x), jf, axis=-1)))


# ---------------------------------------------------------------- baselines
BASELINES = {
    "mx4": lambda m, x: m.mx_quantize(x),
    "mxfp4": lambda m, x: m.mxfp4_quantize(x),
    "vsq": lambda m, x: m.vsq_quantize(x),
    "int4": lambda m, x: m.int_pertensor(x, 4),
    "int8": lambda m, x: m.int_pertensor(x, 8),
    "E2M1_pt": lambda m, x: m.fp_pertensor(x, m.formats.E2M1),
    "E1M2_pt": lambda m, x: m.fp_pertensor(x, m.formats.E1M2),
    "E3M0_pt": lambda m, x: m.fp_pertensor(x, m.formats.E3M0),
    "E5M2_pt": lambda m, x: m.fp_pertensor(x, m.formats.E5M2),
}


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_bit_equal(ref, name):
    fn = BASELINES[name]
    for x in INPUTS:
        got = fn(tbase, torch.from_numpy(x)).numpy()
        want = np.asarray(fn(ref.base, ref.jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)


def test_lloydmax_pertensor_within_tolerance(ref):
    x = _edge_input(2)
    got = tbase.lloydmax_pertensor(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.base.lloydmax_pertensor(ref.jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=LLOYD_TOL, atol=LLOYD_TOL * np.abs(want).max())


# ----------------------------------------------------------------- Lloyd-Max
def test_lloyd_max_pieces(ref):
    rng = np.random.default_rng(3)
    v = rng.laplace(size=5000).astype(np.float32) * 7
    lv = rng.standard_normal(16).astype(np.float32) * 10
    lv[3] = lv[4]  # a duplicate level
    np.testing.assert_array_equal(
        tlm.quantize_to_levels(torch.from_numpy(v), torch.from_numpy(lv)).numpy(),
        np.asarray(ref.lm.quantize_to_levels(ref.jnp.asarray(v), ref.jnp.asarray(lv))))
    qi = np.array(ref.lm.quantile_init(ref.jnp.asarray(v), 16))
    np.testing.assert_allclose(tlm.quantile_init(torch.from_numpy(v), 16).numpy(), qi,
                               rtol=LM_TOL, atol=LM_TOL * np.abs(qi).max())
    assign = rng.integers(0, 8, v.size)
    start = np.tile(np.sort(lv), (8, 1))
    start[5] = np.linspace(-40, 40, 16)  # bins that stay empty keep their level
    want = np.asarray(ref.lm.lloyd_max_batched(ref.jnp.asarray(v), ref.jnp.asarray(assign),
                                               ref.jnp.asarray(start), iters=25))
    got = tlm.lloyd_max_batched(torch.from_numpy(v), torch.from_numpy(assign),
                                torch.from_numpy(start), iters=25).numpy()
    np.testing.assert_allclose(got, want, rtol=LLOYD_TOL, atol=LLOYD_TOL * np.abs(want).max())
    w1 = np.asarray(ref.lm.lloyd_max_1d(ref.jnp.asarray(v), ref.jnp.asarray(qi), iters=30))
    g1 = tlm.lloyd_max_1d(torch.from_numpy(v), torch.from_numpy(qi), iters=30).numpy()
    np.testing.assert_allclose(g1, w1, rtol=LLOYD_TOL, atol=LLOYD_TOL * np.abs(w1).max())


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_jax_random_in_torch(ref, seed):
    jr = ref.jax.random
    key, tkey = jr.PRNGKey(seed), prng.prng_key(seed)
    want = np.asarray(jr.key_data(jr.split(key)) if hasattr(jr, "key_data") else jr.split(key))
    assert np.array_equal(tlm.split(tkey).numpy(), want.astype(np.int64))
    for n in (3, 1000, 61_952):
        assert int(tlm.randint(tkey, (), 0, n)) == int(jr.randint(key, (), 0, n))
    assert np.array_equal(tlm.permutation(tkey, 9000)[:4096].numpy(),
                          np.asarray(jr.choice(key, 9000, (4096,), replace=False)))
    assert np.array_equal(tlm.uniform(tkey, 128, -31.0, 31.0).numpy(),
                          np.asarray(jr.uniform(key, (128,), minval=-31.0, maxval=31.0)))


def test_kmeanspp_seeds_equal(ref):
    blocks = np.random.default_rng(4).standard_normal((3000, 8)).astype(np.float32) * 10
    want = ref.lm.kmeanspp_seeds(ref.jnp.asarray(blocks), 8, ref.jax.random.PRNGKey(11))
    got = tlm.kmeanspp_seeds(torch.from_numpy(blocks), 8, prng.prng_key(11))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- fitting
def _fit_samples():
    rng = np.random.default_rng(5)
    return [rng.standard_normal(6000).astype(np.float32),
            (rng.laplace(size=(40, 64)) * 0.7).astype(np.float32),
            rng.standard_t(4, size=3000).astype(np.float32) * 0.5]


def _same_fit(got, want, exact=True):
    if exact:
        np.testing.assert_array_equal(got.levels, want.levels)
    else:
        np.testing.assert_allclose(got.levels, want.levels, rtol=LLOYD_TOL,
                                   atol=LLOYD_TOL * np.abs(want.levels).max())
    assert len(got.history) == len(want.history)
    np.testing.assert_allclose(got.history, want.history, rtol=HIST_RTOL)
    h = got.history
    assert all(b <= a for a, b in zip(h, h[1:])), h


@pytest.mark.parametrize("kw", [FIT_KW, dict(FIT_KW, max_blocks=1024)],
                         ids=["all_blocks", "max_blocks_subsample"])
def test_fit_lobcq_matches_reference(ref, kw):
    s = _fit_samples()
    want = ref.bcq.fit_lobcq([ref.jnp.asarray(t) for t in s], ref.bcq.BCQConfig(),
                             key=ref.jax.random.PRNGKey(3), **kw)
    got = tbcq.fit_lobcq([torch.from_numpy(t) for t in s], TC, key=prng.prng_key(3), **kw)
    _same_fit(got, want)
    assert got.levels.shape == (8, 16) and np.abs(got.levels).max() <= TC.codeword_max


def test_naive_init_fit_matches_reference(ref):
    s = _fit_samples()
    want = ref.bcq.naive_init_fit([ref.jnp.asarray(t) for t in s], ref.bcq.BCQConfig(),
                                  key=ref.jax.random.PRNGKey(5), **FIT_KW)
    got = tbcq.naive_init_fit([torch.from_numpy(t) for t in s], TC, key=prng.prng_key(5),
                              **FIT_KW)
    _same_fit(got, want)


def test_float_codeword_fit_loads_and_runs_fake(ref, tmp_path):
    """A ``quantize_codewords=False`` fit: raw Lloyd-Max levels (within
    LM_TOL of the reference's), legitimate for ``fake`` mode — it loads,
    and ``bcq.fake_quant`` with it matches the reference's — while the
    kernels' premise (checked at a kernel's entry) refuses it."""
    s = _fit_samples()
    kw = dict(FIT_KW, quantize_codewords=False)
    want = ref.bcq.fit_lobcq([ref.jnp.asarray(t) for t in s], ref.bcq.BCQConfig(),
                             key=ref.jax.random.PRNGKey(3), **kw)
    got = tbcq.fit_lobcq([torch.from_numpy(t) for t in s], TC, key=prng.prng_key(3), **kw)
    _same_fit(got, want, exact=False)
    assert not np.array_equal(got.levels, np.round(got.levels))
    got.save(str(tmp_path / "cb.json"))
    back = tbcq.CodebookSet.load(str(tmp_path / "cb.json"))
    np.testing.assert_array_equal(back.levels, got.levels)
    assert back.history == pytest.approx(got.history)
    x = _edge_input(6, (4, 128))
    cb = torch.from_numpy(want.levels)
    np.testing.assert_array_equal(
        tbcq.fake_quant(torch.from_numpy(x), cb, TC).numpy(),
        np.asarray(ref.bcq.fake_quant(ref.jnp.asarray(x), ref.jnp.asarray(want.levels),
                                      ref.bcq.BCQConfig())))
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        tbcq.check_kernel_codebooks(back.as_tensor(), TC)


def test_fake_quant_plain_equals_reference(ref):
    cb = tcal.default_universal_codebooks()
    for x in INPUTS + [_edge_input(8, (5, 100))]:
        got = tbcq.fake_quant(torch.from_numpy(x), cb.as_tensor(), TC).numpy()
        want = np.asarray(ref.bcq.fake_quant(ref.jnp.asarray(x), ref.jnp.asarray(cb.levels),
                                             ref.bcq.BCQConfig()))
        np.testing.assert_array_equal(got, want)


def test_bitwidth_and_codebook_bytes(ref):
    jc = ref.bcq.BCQConfig()
    assert TC.selector_bits == jc.selector_bits and TC.bitwidth() == jc.bitwidth() == 4.5
    assert TC.bitwidth(4096) == jc.bitwidth(4096)
    cb = tcal.default_universal_codebooks()
    assert cb.nbytes() == ref.cal.default_universal_codebooks().nbytes() == 96.0


# --------------------------------------------------------------- calibration
@pytest.fixture(scope="module")
def dense(ref):
    """Smoke gpt3_126m: the reference's float params (one jax.random draw)
    in both packages, and the calibration tokens of the quantize CLI."""
    cfg = ref.get_smoke("gpt3_126m")
    rt = ref.Runtime(quant_mode="none", compute_dtype=ref.jnp.float32,
                     param_dtype=ref.jnp.float32)
    params = ref.zoo.build(cfg, rt).init(ref.jax.random.PRNGKey(0))
    from repro.data.pipeline import DataConfig, batch_at

    toks = np.asarray(batch_at(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=4),
                               999_999)["tokens"])
    return SimpleNamespace(cfg=cfg, tcfg=t_get_smoke("gpt3_126m"), rt=rt, params=params,
                           tparams=from_numpy_tree(_np(ref, params)), toks=toks,
                           trt=TRuntime(quant_mode="none", compute_dtype=torch.float32))


def test_capture_gemm_inputs_match_reference(ref, dense):
    want = ref.cal.capture_gemm_inputs(dense.params, ref.jnp.asarray(dense.toks), dense.cfg,
                                       dense.rt)
    got = tcal.capture_gemm_inputs(dense.tparams, torch.from_numpy(dense.toks), dense.tcfg,
                                   dense.trt)
    assert len(got) == len(want) == 1 + 2 * dense.cfg.n_layers
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())


def test_calibrate_from_model_matches_reference(ref, dense):
    kw = dict(iters=3, lm_iters=5)
    want = ref.cal.calibrate_from_model(dense.params, ref.jnp.asarray(dense.toks), dense.cfg,
                                        dense.rt, ref.bcq.BCQConfig(), **kw)
    got = tcal.calibrate_from_model(dense.tparams, torch.from_numpy(dense.toks), dense.tcfg,
                                    dense.trt, TC, **kw)
    _same_fit(got, want)


def test_regenerate_writes_elsewhere(monkeypatch, tmp_path):
    """``regenerate`` fits the synthetic mixture and writes under ``_CB_DIR``
    (pointed at a temporary directory: the committed file stays as it is);
    ``save_as_default`` writes there too.  Few iterations, to keep it short."""
    monkeypatch.setattr(tcal, "_CB_DIR", str(tmp_path))
    fit = tcal.calibrate_universal
    monkeypatch.setattr(tcal, "calibrate_universal",
                        lambda s, cfg, **kw: fit(s, cfg, iters=2, lm_iters=3, max_blocks=4096))
    cbs = tcal.default_universal_codebooks(regenerate=True)
    path = tmp_path / "universal_g64_Lb8_Nc8.json"
    assert path.exists() and cbs.levels.shape == (8, 16)
    tbcq.check_codebook_levels(cbs.levels, TC)
    assert all(b <= a for a, b in zip(cbs.history, cbs.history[1:]))
    np.testing.assert_array_equal(tcal.default_universal_codebooks().levels, cbs.levels)
    assert tcal.save_as_default(cbs) == str(path)


# ----------------------------------------------------------------------- ptq
@pytest.fixture(scope="module")
def moe(ref):
    cfg = ref.get_smoke("moonshot_v1_16b")
    rt = ref.Runtime(quant_mode="none", compute_dtype=ref.jnp.float32,
                     param_dtype=ref.jnp.float32)
    params = ref.zoo.build(cfg, rt).init(ref.jax.random.PRNGKey(1))
    return SimpleNamespace(params=params, tparams=from_numpy_tree(_np(ref, params)))


def _by_path(tree, path):
    node = tree
    for k in path.strip("/").split("/"):
        node = node[k]
    return node


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_ptq_tree_matches_reference(ref, dense, moe, family):
    m = dense if family == "dense" else moe
    cb = tcal.default_universal_codebooks()
    jcb, tcb = ref.jnp.asarray(cb.levels), cb.as_tensor()
    want = _np(ref, ref.ptq.quantize_params(m.params, jcb, ref.bcq.BCQConfig()))
    got = tptq.quantize_params(m.tparams, tcb, TC)
    flat = ref.jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
    enc_w = ref.ptq.encode_params(m.params, jcb, ref.bcq.BCQConfig())
    enc_g = tptq.encode_params(m.tparams, tcb, TC)
    assert sorted(enc_g) == sorted(enc_w) and enc_w
    for path, (e, shape) in enc_w.items():
        g, gshape = enc_g[path]
        assert gshape == tuple(shape)
        assert np.asarray(e.s_x).shape == () and float(g.s_x) == float(e.s_x)
        for name in ("packed_idx", "packed_sel", "scale_code"):
            np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(e, name)),
                                          err_msg=f"{path} {name}")
    assert tptq.count_quantized_bits(m.tparams, TC) == ref.ptq.count_quantized_bits(
        m.params, ref.bcq.BCQConfig())
    if family == "moe":
        assert any(leaf.ndim == 4 for leaf, _ in ((g.packed_idx, 0) for g, _ in enc_g.values()))


def test_packed_from_artifact_decodes_to_fake(ref, dense):
    """The packed artifact's tree decodes (per layer, the stack's one s_X
    broadcast) to the fake artifact's weights, within the rounding of
    ``cb · (1/(ŝ_A·s_X))`` against ``cb / (ŝ_A·s_X)``."""
    from repro_torch.models.layers import decode_packed_weight

    cb = tcal.default_universal_codebooks().as_tensor()
    enc = tptq.encode_params(dense.tparams, cb, TC)
    art = {p.strip("/").replace("/", "."): {"idx": e.packed_idx, "sel": e.packed_sel,
                                             "scale": e.scale_code, "s_x": e.s_x}
           for p, (e, _) in enc.items()}
    fake = tptq.quantize_params(dense.tparams, cb, TC)
    tree = tptq.packed_from_artifact(fake, art)
    for name in ("wq", "wk", "wv", "wo"):
        pk = tree["layers"]["attn"][name]["kernel_packed"]
        assert pk["s_x"].shape == (dense.cfg.n_layers,) and "inv_scale" in pk
        for i in range(dense.cfg.n_layers):
            w = decode_packed_weight({k: v[i] for k, v in pk.items()}, TC, cb).T
            ref_w = fake["layers"]["attn"][name]["kernel"][i]
            torch.testing.assert_close(w, ref_w, rtol=1e-6, atol=1e-6 * float(ref_w.abs().max()))
    assert torch.equal(tree["embed"]["kernel"], fake["embed"]["kernel"])


# --------------------------------------------------------------- checkpoints
def _ckpt_tree():
    rng = np.random.default_rng(9)
    return {"a": rng.standard_normal((2, 3)).astype(np.float32),
            "b": {"c": np.float32(1.5), "d": [np.ones((2,), np.float32), np.arange(3, dtype=np.int8)],
                  "layers.attn/wq": rng.integers(0, 255, (4, 2)).astype(np.uint8)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _tree_equal(g, w)
    else:
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert g.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(g, want)


def test_npz_loads_across_packages(ref, tmp_path):
    tree = _ckpt_tree()
    ref.ckpt.save_pytree(str(tmp_path / "ref.npz"), ref.jax.tree.map(ref.jnp.asarray, tree))
    _tree_equal(tckpt.load_pytree(str(tmp_path / "ref.npz")), tree)
    tckpt.save_pytree(str(tmp_path / "port.npz"), _torch_tree(tree))
    _tree_equal(ref.ckpt.load_pytree(str(tmp_path / "port.npz")), tree)
    assert (json.loads((tmp_path / "port.npz.json").read_text())
            == json.loads((tmp_path / "ref.npz.json").read_text()))
    # bf16: the same bytes and sidecar in both; the port loads a bf16 tensor
    bf = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)
    tckpt.save_pytree(str(tmp_path / "bf.npz"), {"w": bf})
    ref.ckpt.save_pytree(str(tmp_path / "bf_ref.npz"),
                         {"w": ref.jnp.asarray(bf.float().numpy(), ref.jnp.bfloat16)})
    for name in ("bf.npz", "bf_ref.npz"):
        back = tckpt.load_pytree(str(tmp_path / name))["w"]
        assert back.dtype == torch.bfloat16 and torch.equal(back, bf)
        meta = json.loads((tmp_path / f"{name}.json").read_text())
        assert meta == {"w": {"dtype": "bfloat16", "shape": [3]}}
        raw = ref.ckpt.load_pytree(str(tmp_path / name))["w"]
        assert raw.dtype.str == "|V2" and raw.tobytes() == bf.view(torch.int16).numpy().tobytes()


def test_checkpoint_roundtrip(tmp_path):
    cm = tckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.tensor(1.5), "d": [torch.ones(2), torch.zeros(3, dtype=torch.int8)]}}
    cm.save(1, tree, blocking=True)
    step, back = cm.restore()
    assert step == 1
    assert torch.equal(back["a"], tree["a"]) and back["b"]["d"][1].dtype == torch.int8
    assert torch.equal(back["b"]["d"][1], tree["b"]["d"][1]) and float(back["b"]["c"]) == 1.5


def test_checkpoint_retention_and_async(tmp_path):
    cm = tckpt.CheckpointManager(str(tmp_path), keep=2, keep_every=2)
    for s in range(1, 6):
        cm.save(s, {"x": torch.full((4,), float(s))}, blocking=True)
    assert cm.all_steps() == [2, 4, 5]  # newest 2, and every 2nd kept
    x = torch.full((4,), 6.0)
    cm.save(6, {"x": x})  # async: the snapshot is taken now
    x.fill_(-1.0)
    cm.wait()
    deadline = time.time() + 5
    while cm.latest_step() != 6 and time.time() < deadline:
        time.sleep(0.05)
    assert cm.latest_step() == 6
    assert torch.equal(cm.restore(6)[1]["x"], torch.full((4,), 6.0))


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp leftover never shadows a committed checkpoint."""
    cm = tckpt.CheckpointManager(str(tmp_path), keep=3)
    cm.save(1, {"x": torch.ones(2)}, blocking=True)
    (tmp_path / "step_00000002.npz.tmp.npz").write_bytes(b"garbage")
    assert cm.latest_step() == 1
    assert torch.equal(cm.restore()[1]["x"], torch.ones(2))
    tckpt.wipe(str(tmp_path))
    assert not tmp_path.exists()


# ---------------------------------------------------------- committed books
def test_committed_codebooks_are_the_reference_file():
    """The port's committed g64 / L_b 8 / N_c 8 file is a byte copy of the
    reference's, after every test above ran (``regenerate`` among them)."""
    port = ROOT / "src" / "repro_torch" / CB_FILE
    assert port.read_bytes() == (ROOT / "src" / "repro" / CB_FILE).read_bytes()
    tbcq.check_codebook_levels(tbcq.CodebookSet.load(str(port)).levels, TC)
