"""The MoE family of the port against the JAX package, on the 2-layer
smokes of ``moonshot_v1_16b`` (MHA) and ``qwen3_moe_235b`` (GQA, kv 2).

Weights and inputs come from one seeded draw on the reference side
(``jax.random`` weights, numpy activations), carried across by
``convert.from_numpy_tree``.  The reference's packed tree is built from
its own ``layers.pack_weight``, nested in ``jax.vmap`` once per stack
axis: its ``ptq.pack_params`` vmaps only 3-D leaves (an (L, E, K, N)
expert leaf reaches ``pack_weight`` whole) and packs an untied
``lm_head`` its packed forward reads as a float kernel (ROADMAP C).

Held here:

* ``ptq.pack_params`` bytes on (L, E, K, N) stacks equal the reference's
  per-(layer, expert) bytes, ``lm_head`` and the router stay float;
* ``moe_ffn`` output and aux within rtol = atol = 1e-5 of the reference's
  in the packed fused, packed unfused and ``none`` modes (the router's f32
  matmul and softmax may differ in the last bits; no input here routes
  differently through a near-tie);
* ``forward_train`` with its 0.01 · aux term within 1e-5, end to end and
  layer by layer on the reference's own inputs — except one named case,
  ``W4A4_FLIPS``: qwen3's packed loss parts from the reference's by a
  quantization step, because the two packages' rmsnorm rounds a last bit
  differently and an activation of layer 0's MoE block sits at a
  quantization boundary (ROADMAP C); there the layer-by-layer check holds;
* greedy serving against ``repro.serving.PagedEngine`` (bcq4, chunked
  prefill, depth 1, ``paged_kernel=False``) under the margin rule with
  ``TOL`` 1e-3, and the port's depth 2 equal to its depth 1 bit for bit;
* top-k's tie rule (lower expert first, as ``jax.lax.top_k``), the
  combine's determinism, the layer-by-layer init.

The ``cuda`` tests hold the expert-stacked fused linear (B1's stacked
launch) to E per-expert launches bit for bit and to its plain version,
and a smoke MoE engine through the kernels to the plain paths; they skip
without a card and need no JAX.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch as t_get_arch
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.core import bcq as tbcq
from repro_torch.core import ptq as tptq
from repro_torch.core.calibrate import default_universal_codebooks as t_codebooks
from repro_torch.kernels import bcq_linear, build, ops
from repro_torch.kernels.ref import fused_linear_experts_ref
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import generate as tgen
from repro_torch.serving.engine import ENGINE_STAT_KEYS, PagedEngine

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("moonshot_v1_16b", "qwen3_moe_235b")
PS, CHUNK, SLOTS, MAX_LEN = 8, 16, 4, 32
ENGINE = dict(n_slots=SLOTS, max_len=MAX_LEN, page_size=PS, prefill_chunk=CHUNK,
              chunked_prefill=True)
TOL = 1e-3
RTOL = ATOL = 1e-5
# (prompt length, max_new): five requests on four slots, so one admission
# waits for a freed slot
WORKLOAD = ((9, 6), (14, 4), (11, 5), (16, 3), (10, 4))
COUNTERS = tuple(k for k in ENGINE_STAT_KEYS if not k.startswith("t_"))
MODES = (("packed", True), ("packed", False), ("none", True))


@pytest.fixture(scope="module")
def ref():
    """The reference package (the parity side; absent where only the port
    runs, and then the tests that take it skip)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import get_smoke
    from repro.core.bcq import BCQConfig
    from repro.core.calibrate import default_universal_codebooks
    from repro.models import layers, moe, transformer, zoo
    from repro.models.layers import Runtime
    from repro.serving import generate
    from repro.serving.engine import PagedEngine as Engine

    return SimpleNamespace(jax=jax, jnp=jnp, get_smoke=get_smoke, bcq_cfg=BCQConfig(),
                           layers=layers, moe=moe, transformer=transformer, zoo=zoo,
                           Runtime=Runtime, gen=generate, Engine=Engine,
                           cb=default_universal_codebooks(BCQConfig()).as_jnp())


def _ref_pack(ref, tree, path=""):
    """The reference's packed layout: every GEMM kernel of the layer stack
    packed per (layer[, expert]) by ``layers.pack_weight`` under nested
    ``jax.vmap``; routers, norms, the embedding and ``lm_head`` as they are."""
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            out[k] = _ref_pack(ref, v, p)
        elif k == "kernel" and p.startswith("/layers/") and "router" not in p:
            fn = lambda w: ref.layers.pack_weight(w, ref.bcq_cfg, ref.cb)  # noqa: E731
            for _ in range(v.ndim - 2):
                fn = ref.jax.vmap(fn)
            out["kernel_packed"] = fn(v)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def models(ref):
    """Per arch: the reference's float and packed trees (numpy) from one
    ``jax.random`` draw, and the reference and port engine-ready models."""
    out = {}
    for arch in ARCHS:
        cfg = ref.get_smoke(arch)
        rt = ref.Runtime(quant_mode="none", compute_dtype=ref.jnp.float32,
                         param_dtype=ref.jnp.float32)
        floats = ref.zoo.build(cfg, rt).init(ref.jax.random.PRNGKey(0))
        packed = _ref_pack(ref, floats)
        packed["codebooks"] = ref.cb
        jrt = ref.Runtime(quant_mode="packed", compute_dtype=ref.jnp.float32,
                          param_dtype=ref.jnp.float32, cache_kind="bcq4", paged_kernel=False,
                          fused_linear=True)
        trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                       paged_kernel=True, fused_linear=True)
        np_floats = ref.jax.tree.map(np.asarray, floats)
        np_packed = ref.jax.tree.map(np.asarray, packed)
        out[arch] = SimpleNamespace(
            cfg=cfg, tcfg=t_get_smoke(arch), floats=floats, packed=packed, np_floats=np_floats,
            np_packed=np_packed, japi=ref.zoo.build(cfg, jrt),
            tapi=tzoo.build(t_get_smoke(arch), trt, device="cpu"))
    return out


def _sub(tree, i):
    if isinstance(tree, dict):
        return {k: _sub(v, i) for k, v in tree.items()}
    return tree[i]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- packing
@pytest.mark.parametrize("arch", ARCHS)
def test_pack_params_bytes_match_reference(ref, models, arch):
    m = models[arch]
    tcb = torch.from_numpy(np.asarray(ref.cb))
    got = tptq.pack_params(from_numpy_tree(m.np_floats), tcb, tptq.bcq.BCQConfig())
    want = from_numpy_tree(m.np_packed)
    e, d, f = m.cfg.moe.n_experts, m.cfg.d_model, m.cfg.moe.d_ff_expert
    for name in ("wi", "wg", "wo"):
        g, w = got["layers"]["moe"][name]["kernel_packed"], want["layers"]["moe"][name]["kernel_packed"]
        n, k = (d, f) if name == "wo" else (f, d)
        assert tuple(g["idx"].shape) == (m.cfg.n_layers, e, n, k // 2)
        assert tuple(g["s_x"].shape) == (m.cfg.n_layers, e)
        for leaf in ("idx", "sel", "scale", "s_x"):
            assert torch.equal(g[leaf], w[leaf]), (name, leaf)
    for name in ("wq", "wk", "wv", "wo"):
        g, w = got["layers"]["attn"][name]["kernel_packed"], want["layers"]["attn"][name]["kernel_packed"]
        for leaf in ("idx", "sel", "scale", "s_x"):
            assert torch.equal(g[leaf], w[leaf]), (name, leaf)
    # the layout the reference's packed forward reads: lm_head and the
    # router stay float kernels
    assert torch.equal(got["lm_head"]["kernel"], want["lm_head"]["kernel"])
    assert torch.equal(got["layers"]["moe"]["router"]["kernel"],
                       want["layers"]["moe"]["router"]["kernel"])


def test_decode_scales_per_layer_and_expert(models):
    m = models["moonshot_v1_16b"]
    tree = tptq.decode_scales(from_numpy_tree(m.np_packed))
    pk = tree["layers"]["moe"]["wo"]["kernel_packed"]
    for i in range(m.cfg.n_layers):
        for e in range(m.cfg.moe.n_experts):
            one = {k: v[i, e] for k, v in pk.items() if k != "inv_scale"}
            assert torch.equal(pk["inv_scale"][i, e], ops.decode_inv_scale(one))


# ---------------------------------------------------------------- moe_ffn
def _ffn_inputs(m, seed=0, b=2, s=24):
    return np.random.default_rng(seed).standard_normal((b, s, m.cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("mode,fused", MODES, ids=["packed-fused", "packed-unfused", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(ref, models, arch, mode, fused):
    m = models[arch]
    x = _ffn_inputs(m)
    src, tsrc = (m.packed, m.np_packed) if mode == "packed" else (m.floats, m.np_floats)
    jrt = ref.Runtime(quant_mode=mode, compute_dtype=ref.jnp.float32,
                      param_dtype=ref.jnp.float32, fused_linear=fused)
    trt = TRuntime(quant_mode=mode, compute_dtype=torch.float32, fused_linear=fused)
    for layer in range(m.cfg.n_layers):
        jo, ja = ref.moe.moe_ffn(ref.jnp.asarray(x), _sub(src["layers"]["moe"], layer), m.cfg,
                                 jrt, ref.cb)
        to, ta = tmoe.moe_ffn(torch.from_numpy(x),
                              from_numpy_tree(_sub(tsrc["layers"]["moe"], layer)), m.tcfg, trt,
                              torch.from_numpy(np.asarray(ref.cb)))
        assert to.shape == x.shape and to.dtype == torch.float32
        _close(to, jo)
        _close(ta, ja)


def test_moe_fake_modes_raise(ref, models):
    """The fake modes are ported: ``moe_ffn`` in ``fake`` and ``fake_full``
    matches the reference's layer by layer (one s_X over the dispatch
    buffer, trash column included); only an unknown mode raises."""
    m = models["moonshot_v1_16b"]
    x = _ffn_inputs(m, 2)
    cb = torch.from_numpy(np.asarray(ref.cb))
    for mode in ("fake", "fake_full"):
        jrt = ref.Runtime(quant_mode=mode, compute_dtype=ref.jnp.float32,
                          param_dtype=ref.jnp.float32)
        for layer in range(m.cfg.n_layers):
            jo, _ = ref.moe.moe_ffn(ref.jnp.asarray(x), _sub(m.floats["layers"]["moe"], layer),
                                    m.cfg, jrt, ref.cb)
            to, _ = tmoe.moe_ffn(torch.from_numpy(x),
                                 from_numpy_tree(_sub(m.np_floats["layers"]["moe"], layer)),
                                 m.tcfg, TRuntime(quant_mode=mode, compute_dtype=torch.float32),
                                 cb)
            _close(to, jo)
    with pytest.raises(ValueError, match="unknown quant_mode"):
        tmoe.moe_ffn(torch.zeros((1, 4, m.cfg.d_model)),
                     from_numpy_tree(_sub(m.np_floats["layers"]["moe"], 0)), m.tcfg,
                     TRuntime(quant_mode="fake_w8"), cb)


# (arch, quant_mode) whose end-to-end packed loss parts from the
# reference's through a W4A4 quantization flip (ROADMAP C): the two
# packages' rmsnorm rounds a last bit differently (f32 sum order), and on
# this input an activation of layer 0's MoE block sits at a quantization
# boundary, so the 4-bit encode turns that bit into a quantization step.
W4A4_FLIPS = {("qwen3_moe_235b", "packed")}


@pytest.mark.parametrize("mode", ["packed", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_with_aux_matches_reference(ref, models, arch, mode):
    """``forward_train`` = loss + 0.01 · aux within 1e-5 of the
    reference's.  Every piece of every layer is also held on the
    reference's own input (teacher-forced: the norms, attention, the MoE
    block's output and aux within 1e-5, and the loss of the reference's
    final hidden states plus the summed aux), which holds
    the whole function where a W4A4 flip parts the end-to-end runs: the
    case of ``W4A4_FLIPS``, whose first differing input is checked to be a
    last-bit difference."""
    m = models[arch]
    rng = np.random.default_rng(5)
    tok = rng.integers(0, m.cfg.vocab, (2, 16)).astype(np.int32)
    lab = rng.integers(0, m.cfg.vocab, (2, 16)).astype(np.int32)
    src, tsrc = (m.packed, m.np_packed) if mode == "packed" else (m.floats, m.np_floats)
    jrt = ref.Runtime(quant_mode=mode, compute_dtype=ref.jnp.float32,
                      param_dtype=ref.jnp.float32, fused_linear=True)
    trt = TRuntime(quant_mode=mode, compute_dtype=torch.float32, fused_linear=True)
    jb = {"tokens": ref.jnp.asarray(tok), "labels": ref.jnp.asarray(lab)}
    want = ref.transformer.forward_train(src, jb, m.cfg, jrt)
    tparams = from_numpy_tree(tsrc)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    got = ttf.forward_train(tparams, batch, m.tcfg, trt)

    # teacher-forced: each layer on the reference's input
    jcb = ref.cb if mode == "packed" else None
    tcb = tparams["codebooks"] if mode == "packed" else None
    x = ref.transformer.embed_tokens(src, jb["tokens"], jrt)
    pos = ref.jnp.broadcast_to(ref.jnp.arange(16)[None, :], (2, 16))
    tpos = torch.arange(16)[None, :].expand(2, 16)
    _close(ttf.embed_tokens(tparams, batch["tokens"], trt), x)
    aux_sum = 0.0
    for i in range(m.cfg.n_layers):
        jp, tp = _sub(src["layers"], i), _sub(tparams["layers"], i)
        for sub in ("attn", "moe"):
            jh = ref.layers.norm_apply(x, jp["ln1" if sub == "attn" else "ln2"], m.cfg.norm)
            th = torch.from_numpy(np.array(jh))
            _close(ttf.layers.norm_apply(torch.from_numpy(np.array(x)),
                                         tp["ln1" if sub == "attn" else "ln2"], m.tcfg.norm), jh)
            if sub == "attn":
                jo, _ = ref.layers.attention(jh, jp["attn"], m.cfg, jrt, jcb, pos)
                to, _ = ttf.layers.attention(th, tp["attn"], m.tcfg, trt, tcb, tpos, None)
            else:
                jo, ja = ref.moe.moe_ffn(jh, jp["moe"], m.cfg, jrt, jcb)
                to, ta = tmoe.moe_ffn(th, tp["moe"], m.tcfg, trt, tcb)
                _close(ta, ja)
                aux_sum = aux_sum + np.float32(ja)
            _close(to, jo)
            x = x + jo
    hid = ref.layers.norm_apply(x, src["ln_f"], m.cfg.norm)
    t_hid = ttf.layers.norm_apply(torch.from_numpy(np.array(x)), tparams["ln_f"], m.tcfg.norm)
    _close(ttf.xent_loss(tparams, t_hid, batch["labels"], trt) + 0.01 * aux_sum,
           ref.transformer.xent_loss(src, hid, jb["labels"], jrt) + 0.01 * aux_sum)
    if (arch, mode) in W4A4_FLIPS:
        # end to end, layer 0's MoE input differs in last bits only, and
        # the loss moves by a quantization step, not by rounding
        h = ttf.layers.norm_apply(ttf.embed_tokens(tparams, batch["tokens"], trt),
                                  _sub(tparams["layers"], 0)["ln1"], m.tcfg.norm)
        jh = ref.layers.norm_apply(ref.transformer.embed_tokens(src, jb["tokens"], jrt),
                                   _sub(src["layers"], 0)["ln1"], m.cfg.norm)
        assert 0 < float((h - torch.from_numpy(np.array(jh))).abs().max()) <= 1e-6
        assert abs(float(got) - float(want)) > ATOL + RTOL * abs(float(want))
    else:
        _close(got, want)
    # the aux term is there: the loss without it differs by 0.01 · aux
    hx, aux = ttf._forward(tparams, batch["tokens"], m.tcfg, trt)
    assert float(aux) > 0
    _close(got - ttf.xent_loss(tparams, hx, batch["labels"], trt), 0.01 * aux)


def test_top_k_ties_take_the_lower_expert(ref, models):
    """An all-equal router row (zero router): every expert ties, and top-k
    takes experts 0 … k-1 in order, as ``jax.lax.top_k``; so those experts
    take the first ``cap`` tokens and the rest get padding, and the block
    equals the reference's."""
    m = models["qwen3_moe_235b"]
    p = from_numpy_tree(_sub(m.np_floats["layers"]["moe"], 0))
    p["router"]["kernel"] = torch.zeros_like(p["router"]["kernel"])
    seen = {}

    def spy(xe, wp, rt, cb, tag=None):
        seen.setdefault(tag, xe.clone())
        return real(xe, wp, rt, cb, tag)

    real = tmoe._expert_matmul
    tmoe._expert_matmul = spy
    x = _ffn_inputs(m, 1, 1, 6)
    rt = TRuntime(compute_dtype=torch.float32)
    try:
        out, aux = tmoe.moe_ffn(torch.from_numpy(x), p, m.tcfg, rt, None)
    finally:
        tmoe._expert_matmul = real
    k, e = m.cfg.moe.top_k, m.cfg.moe.n_experts
    cap = int(m.cfg.moe.capacity_factor * 6 * k / e) + 1
    probs = ref.jnp.full((6, e), 1.0 / e, ref.jnp.float32)
    assert np.asarray(ref.jax.lax.top_k(probs, k)[1]).tolist() == [list(range(k))] * 6
    xe = seen["moe_wi"]  # (E, C, D)
    assert xe.shape[1] == cap
    assert torch.equal(xe[:k], torch.from_numpy(x).reshape(6, -1)[:cap][None].expand(k, -1, -1))
    assert not xe[k:].any()
    jp = dict(_sub(m.floats["layers"]["moe"], 0),
              router={"kernel": ref.jnp.zeros((m.cfg.d_model, e), ref.jnp.float32)})
    jrt = ref.Runtime(quant_mode="none", compute_dtype=ref.jnp.float32,
                      param_dtype=ref.jnp.float32)
    jo, ja = ref.moe.moe_ffn(ref.jnp.asarray(x), jp, m.cfg, jrt, None)
    _close(out, jo)
    _close(aux, ja)


def test_combine_is_deterministic(models):
    m = models["moonshot_v1_16b"]
    p = from_numpy_tree(_sub(m.np_packed["layers"]["moe"], 1))
    x = torch.from_numpy(_ffn_inputs(m, 3))
    rt = TRuntime(quant_mode="packed", compute_dtype=torch.float32)
    cb = t_codebooks().as_tensor()
    first, aux1 = tmoe.moe_ffn(x, p, m.tcfg, rt, cb)
    second, aux2 = tmoe.moe_ffn(x.clone(), p, m.tcfg, rt, cb)
    assert torch.equal(first, second) and torch.equal(aux1, aux2)


# ------------------------------------------------------------------ serving
def _tokens(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int64)


def _serve_port(m, **kw):
    eng = PagedEngine(m.tapi, from_numpy_tree(m.np_packed), device="cpu", **{**ENGINE, **kw})
    for rid, (n, max_new) in enumerate(WORKLOAD):
        eng.submit(tgen.Request(rid=rid, prompt=_tokens(m.cfg.vocab, n, rid), max_new=max_new))
    eng.run_to_completion()
    assert all(r.error is None for r in eng.finished)
    return eng


@pytest.fixture(scope="module")
def port_runs(models):
    """The port engine's runs at depth 1 and depth 2, per arch."""
    return {arch: {d: _serve_port(models[arch], pipeline_depth=d) for d in (1, 2)}
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_reference_engine(ref, models, port_runs, arch):
    m = models[arch]
    jeng = ref.Engine(m.japi, m.packed, pipeline_depth=1, **ENGINE)
    for rid, (n, max_new) in enumerate(WORKLOAD):
        jeng.submit(ref.gen.Request(rid=rid, prompt=_tokens(m.cfg.vocab, n, rid),
                                    max_new=max_new))
    jeng.run_to_completion()
    teng = port_runs[arch][1]
    got = {(r.rid, r.sample_idx): r for r in teng.finished}
    want = {}
    for r in jeng.finished:  # the reference records no margins or launches
        g = got[(r.rid, r.sample_idx)]
        want[(r.rid, r.sample_idx)] = SimpleNamespace(
            out=list(r.out), launch_ids=list(g.launch_ids)[: len(r.out)],
            margins=list(g.margins))
    agree = tgen.greedy_agreement(want, got, TOL)
    assert agree["ok"], (agree, {k: r.out for k, r in want.items()},
                         {k: r.out for k, r in got.items()})
    assert agree["equal_tokens"] > 0
    assert sorted(got) == sorted(want) == [(i, 0) for i in range(len(WORKLOAD))]
    if agree["first_diff_launch"] is None:
        assert {k: r.out for k, r in want.items()} == {k: r.out for k, r in got.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_depth2_equals_depth1(port_runs, arch):
    d1, d2 = port_runs[arch][1], port_runs[arch][2]

    def outcome(eng):
        return ({(r.rid, r.sample_idx): (list(r.out), list(r.margins), list(r.launch_ids))
                 for r in eng.finished}, {k: eng.stats[k] for k in COUNTERS})

    assert outcome(d1) == outcome(d2)
    assert d1.pool.keys() == d2.pool.keys()
    for n in d1.pool:
        assert torch.equal(d1.pool[n], d2.pool[n]), n


# ---------------------------------------------------------- model building
def test_zoo_names_the_families_still_to_port():
    cfg = t_get_smoke("moonshot_v1_16b")
    import dataclasses

    with pytest.raises(NotImplementedError, match="ssm, hybrid, encdec"):
        tzoo.build(dataclasses.replace(cfg, family="ssm"), TRuntime(), device="cpu")


def test_moe_init_draws_layer_by_layer():
    """Layer i's weights come from its own (seed, i) generator: a deeper
    model's first layers equal a shallower one's, and every layer is
    packed (its float experts are not kept)."""
    import dataclasses

    cfg = t_get_smoke("moonshot_v1_16b")
    rt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4")
    two = tzoo.build(cfg, rt, device="cpu").init(3)
    three = tzoo.build(dataclasses.replace(cfg, n_layers=3), rt, device="cpu").init(3)
    for (ka, a), (kb, b) in zip(_leaves(two["layers"]), _leaves(three["layers"])):
        assert ka == kb and torch.equal(a, b[:2]), ka
    assert all("kernel" not in k.split("/")[-1] or "router" in k for k, _ in _leaves(two["layers"]))
    assert torch.equal(two["embed"]["kernel"], three["embed"]["kernel"])
    assert not torch.equal(two["layers"]["moe"]["wi"]["kernel_packed"]["idx"][0],
                           two["layers"]["moe"]["wi"]["kernel_packed"]["idx"][1])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def test_full_width_config_and_bytes():
    """Moonlight's published shape, and the packed bytes of its experts
    (idx 0.5, sel 1/16, scale 1/64, decoded inv_scale 4/64 bytes per
    weight): ~17 GB."""
    cfg = t_get_arch("moonshot_v1_16b")
    m = cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab) == (
        48, 2048, 16, 16, 128, 163840)
    assert (m.n_experts, m.top_k, m.d_ff_expert, m.capacity_factor) == (64, 6, 1408, 1.25)
    weights = cfg.n_layers * m.n_experts * 3 * cfg.d_model * m.d_ff_expert
    assert weights == 26_575_110_144
    assert 16e9 < weights * (1 / 2 + 1 / 16 + 1 / 64 + 4 / 64) < 18e9


def test_cli_serves_the_moe_smoke_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "moonshot_v1_16b",
         "--smoke", "--device", "cpu", "--paged", "--packed", "--chunked-prefill",
         "--cache", "bcq4", "--batch", "2", "--prompt-len", "12", "--gen", "4",
         "--page-size", "8"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "moonshot" in res.stdout


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (E, C, K, N): decode (C 1), a 512-token chunk's wo (C 61), a ragged stack
STACKED_SHAPES = [(64, 1, 2048, 1408), (64, 61, 1408, 2048), (3, 37, 192, 100)]


def stacked_case(e, c, k, n, seed, device):
    """Seeded expert rows (outlier channels, some all-zero padding rows)
    and an (E, N, K) packed weight stack (per-expert s_W)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((e, c, k), generator=g)
    x[..., :: max(1, k // 8)] *= 12.0
    x[:, -1] = 0.0  # a padding row per expert, as dispatch leaves them
    w = torch.randn((e, k, n), generator=g) * k**-0.5
    cb = t_codebooks().as_tensor(device)
    pk = tptq.decode_scales({"kernel_packed": tptq.pack_stack(w.to(device), cb,
                                                              tbcq.BCQConfig())})
    return x.to(device), ops.packed_operand(pk["kernel_packed"]), cb


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STACKED_SHAPES, ids=lambda s: "E{}_C{}_K{}_N{}".format(*s))
def test_stacked_linear_equals_per_expert_launches(cuda, shape):
    e, c, k, n = shape
    x, w, cb = stacked_case(e, c, k, n, sum(shape), cuda)
    cfg = tbcq.BCQConfig()
    s_x = tbcq.tensor_scale(x, cfg)
    before = bcq_linear.BCQ_LINEAR_EXPERTS.count
    got = bcq_linear.bcq_linear_experts(x, w.idx_packed, w.sel_packed, w.inv_scale, cb, s_x, cfg)
    assert bcq_linear.BCQ_LINEAR_EXPERTS.count == before + 1
    each = torch.stack([bcq_linear.bcq_linear(x[i].contiguous(), w.idx_packed[i],
                                              w.sel_packed[i], w.inv_scale[i], cb, s_x, cfg)
                        for i in range(e)])
    assert torch.equal(got, each)  # the per-expert launches' bits
    want = fused_linear_experts_ref(x, w.idx_packed, w.sel_packed, w.inv_scale, cb, cfg, s_x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_smoke_moe_engine_through_kernels(cuda):
    """The moonshot smoke through the kernels (graph depth 2 and eager
    depth 1, bit for bit) and through the plain paths (margin rule); the
    stacked B1 launched 3 × layers a pass, the dense B1 4 × layers."""
    from repro_torch.launch.serve import serve

    cfg = t_get_smoke("moonshot_v1_16b")
    prompts = [_tokens(cfg.vocab, n, i) for i, (n, _) in enumerate(WORKLOAD)]
    runs = {}
    for name, kw in (("graph2", {}), ("eager1", {"pipeline_depth": 1, "cuda_graphs": False}),
                     ("plain", {"kernels": False, "pipeline_depth": 1, "cuda_graphs": False})):
        build.reset_counts()
        fin, eng = serve(cfg, prompts, 6, page_size=8, prefill_chunk=16, device="cuda",
                         chunked_prefill=True, prefix_caching=False, **kw)
        torch.cuda.synchronize()
        runs[name] = ({r.rid: r for r in fin}, eng, build.counts())
    (f2, e2, c2), (f1, e1, c1), (fp, _, cp) = runs["graph2"], runs["eager1"], runs["plain"]
    assert {k: (r.out, r.margins) for k, r in f2.items()} == {
        k: (r.out, r.margins) for k, r in f1.items()}
    assert all(torch.equal(e2.pool[n], e1.pool[n]) for n in e1.pool)
    passes = e1.stats["decode_ticks"] + e1.stats["prefill_launches"]
    assert c1["bcq_linear_experts"] == c2["bcq_linear_experts"] == 3 * cfg.n_layers * passes
    assert c1["bcq_linear"] == 4 * cfg.n_layers * passes
    assert not cp.get("bcq_linear_experts") and not cp.get("bcq_linear")
    assert tgen.greedy_agreement(fp, f1, TOL)["ok"]
