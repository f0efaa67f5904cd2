"""The rest of the model zoo against the JAX package: the configs
``qwen2_0_5b``, ``starcoder2_3b``, ``phi3_medium_14b``, ``qwen1_5_32b``
(dense) and ``pixtral_12b`` (vlm), the ``vlm`` family's patch embeddings,
the dense family's layer-by-layer init, and the contiguous decode's
prefix read against the reference's bounded reads, on each config's
2-layer ``smoke()``.

Weights are the reference's (one ``jax.random`` draw a config, carried
across by ``convert.from_numpy_tree``; its fake-quant tree by its own
``ptq.quantize_params``; its packed tree by its own ``pack_params`` with
``lm_head`` left float, the layout its packed forward reads); inputs are
numpy-seeded; the reference's functions run jitted, once a config and
mode.  The cache is bcq4 in every mode (the serving configuration).

Tolerances, f32 throughout:

* ``loss_fn`` at ``none``, ``fake`` and ``packed``: 1e-5 relative;
* ``prefill`` logits and the logits of three ``decode_step``s:
  rtol 1e-5, atol 1e-5 · max|ref|;
* ``pack_params`` bytes and the converted trees: equal;
* the layer-by-layer init: the bytes of ``pack_params`` over the same
  per-layer draws stacked;
* the port's decode (it reads the written prefix of the cache) against
  the reference's with ``kv_bound`` None, S + 1 and 16: the decode's
  tolerance.

Qwen2's smoke has d_model 112, which is not a whole number of 64-wide
arrays.  Neither package's packed forward runs it (the fused linear
refuses K % L_A != 0; the unfused one multiplies x (…, 112) by the
decoded (N, 128) weight), so for that config the ``packed`` cases run
``fake_full`` on the float tree in both (``PACKED_AS_FAKE_FULL``): the
same math, since a packed weight's decode is bit for bit its
``fake_quant`` (``src/repro/core/bcq.py:247``).  Its packed bytes are
still held.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.core import ptq as tptq
from repro_torch.core.bcq import BCQConfig as TCfg
from repro_torch.models import transformer as ttr
from repro_torch.models import zoo as tzoo
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving.engine import PagedEngine as TPagedEngine
from repro_torch.serving.state_engine import StatePagedEngine as TStatePagedEngine

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.core.bcq import BCQConfig as JCfg  # noqa: E402
from repro.core.calibrate import default_universal_codebooks  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402

ZOO = ["qwen2_0_5b", "starcoder2_3b", "phi3_medium_14b", "qwen1_5_32b", "pixtral_12b"]
MODES = ["none", "fake", "packed"]
PACKED_AS_FAKE_FULL = {"qwen2_0_5b"}
CB = default_universal_codebooks(JCfg()).as_jnp()
TCB = torch.from_numpy(np.array(CB))
RTOL = 1e-5
B, S, MAX_LEN = 2, 12, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=what)


def _no_lm_head(path, leaf):
    return jptq._is_gemm_weight(path, leaf) and "lm_head" not in path


def _rts(mode, arch):
    mode = "fake_full" if mode == "packed" and arch in PACKED_AS_FAKE_FULL else mode
    return (JRuntime(quant_mode=mode, compute_dtype=jnp.float32, param_dtype=jnp.float32,
                     cache_kind="bcq4"),
            TRuntime(quant_mode=mode, compute_dtype=torch.float32, cache_kind="bcq4"))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """The reference's float, fake and packed trees of the smoke (each with
    the codebooks) and the port's copies of them."""
    cfg = jbase.get_smoke(arch)
    jrt, _ = _rts("none", arch)
    floats = jax.jit(jzoo.build(cfg, jrt).init)(jax.random.PRNGKey(0))
    fake = jax.jit(lambda p: jptq.quantize_params(p, CB, JCfg()))(floats)
    packed = jax.jit(lambda p: jptq.pack_params(p, CB, JCfg(), predicate=_no_lm_head))(floats)
    for t in (floats, fake, packed):
        t["codebooks"] = CB
    trees = {"none": floats, "fake": fake,
             "packed": floats if arch in PACKED_AS_FAKE_FULL else packed}
    return cfg, trees, {m: from_numpy_tree(_np(t)) for m, t in trees.items()}


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = (rng.normal(size=(B, cfg.n_patches, cfg.d_model)) * 0.02
                                 ).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", tbase.ARCH_IDS + ["gpt3_126m"])
def test_configs_are_the_references(arch):
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    for ours, ref in ((tbase.get_arch(arch), jbase.get_arch(arch)),
                      (tbase.get_smoke(arch), jbase.get_smoke(arch))):
        for f in dataclasses.fields(ref):
            got, want = getattr(ours, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
            else:
                assert got == want, (arch, f.name)
        assert ours.head_dim == ref.head_dim and ours.vocab_padded == ref.vocab_padded


def test_zoo_full_widths():
    """The published shapes the card serves (phase 22)."""
    q2, sc, phi, q32, pix = (tbase.get_arch(a) for a in ZOO)
    assert (q2.d_model, q2.n_heads, q2.n_kv_heads, q2.head_dim, q2.vocab_padded) == (
        896, 14, 2, 64, 152064)
    assert (sc.n_layers, sc.act, sc.norm, sc.tie_embeddings) == (30, "gelu", "layernorm", False)
    assert (phi.n_heads // phi.n_kv_heads, phi.head_dim, phi.vocab_padded) == (4, 128, 100352)
    assert (q32.n_layers, q32.d_ff, q32.n_kv_heads, q32.vocab_padded) == (64, 27392, 40, 152064)
    assert pix.family == "vlm" and pix.n_heads * pix.head_dim == 4096 != pix.d_model
    assert pix.n_patches == 256 and pix.vocab_padded == 131072


# ------------------------------------------------------------ model parity
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ZOO)
def test_loss_matches_reference(arch, mode):
    cfg, jtrees, ttrees = _model(arch)
    jrt, trt = _rts(mode, arch)
    batch = _inputs(cfg, 1)
    want = jax.jit(jzoo.build(cfg, jrt).loss_fn)(jtrees[mode], jax.tree.map(jnp.asarray, batch))
    got = tzoo.build(tbase.get_smoke(arch), trt, device="cpu").loss_fn(ttrees[mode], _tb(batch))
    assert abs(float(got) - float(want)) <= RTOL * abs(float(want)), (float(got), float(want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_decode_match_reference(arch, mode):
    """Prefill logits, then three contiguous decode steps of seeded tokens
    (positions S, S + 1, S + 2) over the bcq4 caches each package filled."""
    cfg, jtrees, ttrees = _model(arch)
    jrt, trt = _rts(mode, arch)
    japi, tapi = jzoo.build(cfg, jrt), tzoo.build(tbase.get_smoke(arch), trt, device="cpu")
    batch = _inputs(cfg, 2)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    jl, jc = jax.jit(lambda p, b: japi.prefill_fn(p, b, MAX_LEN))(
        jtrees[mode], jax.tree.map(jnp.asarray, pre))
    tl, tc = tapi.prefill_fn(ttrees[mode], _tb(pre), MAX_LEN)
    _close(tl, jl, "prefill")
    step = jax.jit(japi.decode_fn)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, B, 1)).astype(np.int32)
    for t in range(3):
        jl, jc = step(jtrees[mode], jc, jnp.asarray(toks[t]), jnp.int32(S + t))
        tl, tc = tapi.decode_fn(ttrees[mode], tc, torch.from_numpy(toks[t]), S + t)
        _close(tl, jl, f"decode step {t}")


@pytest.mark.parametrize("arch", ZOO)
def test_pack_params_bytes_match_reference(arch):
    """The port's ``pack_params`` of the converted float tree: the
    reference's packed bytes (``lm_head`` float in both), leaf for leaf."""
    cfg, _, ttrees = _model(arch)
    packed = jax.jit(lambda p: jptq.pack_params(p, CB, JCfg(), predicate=_no_lm_head))(
        _model(arch)[1]["none"])
    floats = {k: v for k, v in ttrees["none"].items() if k != "codebooks"}
    ours = tptq.pack_params(floats, TCB, TCfg())
    flat = jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in packed.items() if k != "codebooks"})[0]
    for path, leaf in flat:
        node = ours
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    assert ("lm_head" in ours) == (not cfg.tie_embeddings)
    if "lm_head" in ours:
        assert ours["lm_head"]["kernel"].dtype == torch.float32


# ---------------------------------------------------------- the vlm family
def test_vlm_patch_embeds_replace_the_first_positions():
    """``patch_embeds`` (B, n, d) replace the embedded prompt's first n
    positions; a prompt shorter than n is refused by name."""
    tcfg = tbase.get_smoke("pixtral_12b")
    _, _, ttrees = _model("pixtral_12b")
    p = ttrees["none"]
    rt = TRuntime(compute_dtype=torch.float32)
    batch = _tb(_inputs(tcfg, 4))
    x = ttr.embed_inputs(p, batch, tcfg, rt)
    pe = batch["patch_embeds"]
    assert torch.equal(x[:, :tcfg.n_patches], pe)
    assert torch.equal(x[:, tcfg.n_patches:], ttr.embed_tokens(p, batch["tokens"], rt)[:, tcfg.n_patches:])
    short = {"tokens": batch["tokens"][:, :tcfg.n_patches - 1], "patch_embeds": pe}
    with pytest.raises(ValueError, match="patch_embeds"):
        ttr.embed_inputs(p, short, tcfg, rt)
    dense = dataclasses.replace(tcfg, family="dense")  # only a vlm reads them
    assert torch.equal(ttr.embed_inputs(p, batch, dense, rt),
                       ttr.embed_tokens(p, batch["tokens"], rt))


def test_vlm_builds_without_a_page_spec_and_both_engines_refuse_it():
    tcfg = tbase.get_smoke("pixtral_12b")
    api = tzoo.build(tcfg, TRuntime(compute_dtype=torch.float32), device="cpu")
    assert api.page_spec is None and api.paged_decode_fn is not None
    params = api.init(0)
    for engine in (TPagedEngine, TStatePagedEngine):
        with pytest.raises(tzoo.UnsupportedModelError, match="family 'vlm'") as ei:
            engine(api, params, n_slots=2, max_len=16, page_size=8, device="cpu")
        assert ei.value.family == "vlm" and ei.value.supported == tzoo.SERVED_FAMILIES
    with pytest.raises(ValueError, match="nonesuch"):
        tzoo.build(dataclasses.replace(tcfg, family="nonesuch"), TRuntime(), device="cpu")


# ------------------------------------------------------- layer-by-layer init
@pytest.mark.parametrize("arch", ZOO)
def test_dense_init_draws_and_packs_layer_by_layer(arch):
    """``init`` draws layer i from generator (seed, i) and packs it before
    the next: the bytes of ``pack_params`` over the same per-layer draws
    stacked (one s_X a layer), the float ``lm_head`` and embedding too."""
    tcfg = tbase.get_smoke(arch)
    rt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4")
    params = tzoo.build(tcfg, rt, device="cpu").init(3)
    floats = ttr.init_top(tcfg, rt, tzoo._generator("cpu", 3, -1))
    floats["layers"] = ttr.stack_layers([ttr.init_block(tcfg, rt, tzoo._generator("cpu", 3, i))
                                         for i in range(tcfg.n_layers)])
    want = tptq.decode_scales(tptq.pack_params(floats, TCB, TCfg()))
    want["codebooks"] = TCB

    def walk(a, b, path=""):
        assert isinstance(a, dict) == isinstance(b, dict), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert torch.equal(a, b), path

    walk(params, want)
    assert "mlp" in params["layers"] and "kernel_packed" in params["layers"]["mlp"]["wo"]
    deeper = tzoo.build(dataclasses.replace(tcfg, n_layers=3), rt, device="cpu").init(3)
    for k in ("idx", "sel", "scale"):
        assert torch.equal(deeper["layers"]["mlp"]["wo"]["kernel_packed"][k][:2],
                           params["layers"]["mlp"]["wo"]["kernel_packed"][k])


# ------------------------------------------------------------ bounded reads
@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
def test_prefix_read_matches_reference_bounded_reads(kind):
    """A packed decode step after a prefill: the port reads the written
    prefix of the cache; the reference's logits with ``kv_bound`` None
    (the whole cache), S + 1 (the prefix) and 16 (a bucket) are its
    logits at the decode's tolerance."""
    arch = "phi3_medium_14b"
    cfg, jtrees, ttrees = _model(arch)
    jrt, trt = (dataclasses.replace(r, cache_kind=kind) for r in _rts("packed", arch))
    japi, tapi = jzoo.build(cfg, jrt), tzoo.build(tbase.get_smoke(arch), trt, device="cpu")
    pre = {"tokens": _inputs(cfg, 5)["tokens"]}
    tok = np.full((B, 1), 7, np.int32)
    _, tc = tapi.prefill_fn(ttrees["packed"], _tb(pre), MAX_LEN)
    got, _ = tapi.decode_fn(ttrees["packed"], tc, torch.from_numpy(tok), S)
    prefill = jax.jit(lambda p, b: japi.prefill_fn(p, b, MAX_LEN))
    for bound in (None, S + 1, 16):
        _, jc = prefill(jtrees["packed"], jax.tree.map(jnp.asarray, pre))
        step = jax.jit(functools.partial(japi.decode_fn, kv_bound=bound))
        want, _ = step(jtrees["packed"], jc, jnp.asarray(tok), jnp.int32(S))
        _close(got, want, f"kv_bound {bound}")
