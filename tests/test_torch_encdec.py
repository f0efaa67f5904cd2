"""The port's Whisper-style encoder-decoder (``repro_torch/models/encdec.py``),
its config, its zoo branch, the attention branches it adds to
``layers.py`` (bidirectional, cross-attention with ``kv_override``, the
per-row decode) and ``prng.normal``, against the JAX package, on the
``whisper_base`` smoke (2 encoder and 2 decoder layers, d 128, 4 heads of
32, d_ff 256, gelu, layernorm, vocab 512, 64 frames).

Weights are the reference's (one ``jax.random`` draw, carried across by
``convert.from_numpy_tree``; its packed tree built by its own
``pack_params``); frames (numpy-seeded normals · 0.02) and tokens are
numpy-seeded; the reference's functions run jitted.  Tolerances, f32
throughout:

* ``_sinusoidal`` / ``_sinusoidal_at``: atol 2e-5 (the same f32 ops; XLA's
  sin and cos on the CPU are its own polynomials, and arguments reach
  1,500 radians);
* ``quant_mode="none"``: every output within 1e-5 of max|ref| (rtol 1e-5);
* ``quant_mode="packed"``: packed bytes and E4M3 codes equal, and outputs
  within 1e-4 of max|ref| (rtol 1e-4) — on these inputs no launch's
  activation scale ``s_x`` flips between the packages (the first flip
  would part every later launch; none occurs here);
* bcq4 self caches: bytes equal;
* decode ≡ parallel in the port itself: rtol 5e-3, atol 5e-3, as
  ``tests/test_models_smoke.py::test_decode_matches_parallel_whisper``;
* ``prng.normal`` against ``jax.random.normal(PRNGKey(11), (64, 128))``:
  within 4 ulps of each value (XLA's ``log1p`` and fused multiply-adds in
  its ``erf_inv``), the uniforms under it bit-equal.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch as t_get_arch
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.models import encdec as tenc
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models import zoo as tzoo
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import pages as tpages
from repro_torch.serving import prng

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.core.bcq import BCQConfig as JCfg  # noqa: E402
from repro.core.calibrate import default_universal_codebooks  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro_torch.core import bcq as tbcq  # noqa: E402
from repro_torch.core import ptq as tptq  # noqa: E402
from repro_torch.core.bcq import BCQConfig as TCfg  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402

ARCH = "whisper_base"
CFG, TCFG = get_smoke(ARCH), t_get_smoke(ARCH)
T, D = CFG.encoder_len, CFG.d_model
CB = default_universal_codebooks(JCfg()).as_jnp()
TCB = torch.from_numpy(np.array(CB))
ML = 32  # the self caches' max_len
RTOL = {"none": 1e-5, "packed": 1e-4}


def _rts(mode):
    return (JRuntime(quant_mode=mode, compute_dtype=jnp.float32, param_dtype=jnp.float32,
                     cache_kind="bcq4"),
            TRuntime(quant_mode=mode, compute_dtype=torch.float32, cache_kind="bcq4"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, mode="none", what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL[mode], atol=RTOL[mode] * np.abs(want).max(),
                               err_msg=what)


def _same_leaves(t_tree, j_tree, what=""):
    tl, jl = tpages.tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl), what
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)


@functools.lru_cache(maxsize=None)
def _models():
    """(float params, packed params) of the reference, both with the
    codebooks (a bcq4 cache reads them at any mode), and the port's copies."""
    jrt, _ = _rts("none")
    params = jax.jit(jzoo.build(CFG, jrt).init)(jax.random.PRNGKey(0))
    packed = jax.jit(lambda p: jptq.pack_params(p, CB, JCfg()))(params)
    params["codebooks"] = packed["codebooks"] = CB
    return params, packed, from_numpy_tree(_np(params)), from_numpy_tree(_np(packed))


def _pick(mode):
    params, packed, tparams, tpacked = _models()
    return (packed, tpacked) if mode == "packed" else (params, tparams)


def _inputs(b=2, s=9, seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(b, T, D)) * 0.02).astype(np.float32)
    tokens = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    return frames, tokens


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ------------------------------------------------------------------ config
def test_config_is_the_references():
    import repro.configs.whisper_base as jmod

    for ours, ref in ((t_get_arch(ARCH), jmod.CONFIG), (TCFG, CFG)):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    full = t_get_arch(ARCH)
    assert (full.n_layers, full.n_encoder_layers, full.d_model, full.head_dim, full.d_ff,
            full.encoder_len, full.vocab_padded) == (6, 6, 512, 64, 2048, 1500, 51968)
    assert full.tie_embeddings and full.act == "gelu" and full.norm == "layernorm"


def test_sinusoidal():
    for length, d in ((T, D), (1500, 512)):
        np.testing.assert_allclose(tenc._sinusoidal(length, d).numpy(),
                                   np.asarray(jax.jit(jenc._sinusoidal, static_argnums=(0, 1))(
                                       length, d)), rtol=0, atol=2e-5)
    pos = np.random.default_rng(1).integers(0, 448, (3, 7)).astype(np.int32)
    np.testing.assert_allclose(tenc._sinusoidal_at(_t(pos), D).numpy(),
                               np.asarray(jax.jit(lambda p: jenc._sinusoidal_at(p, D))(pos)),
                               rtol=0, atol=2e-5)


def test_prng_normal_matches_jax():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (64, 128)))
    got = prng.normal(prng.prng_key(11), 64 * 128).reshape(64, 128).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_less(np.abs(got - want), 4 * np.spacing(np.abs(want)) + 1e-30)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    np.testing.assert_array_equal(  # the uniforms under it, bit for bit
        prng.uniform(prng.prng_key(11), 64 * 128, float(lo), 1.0).reshape(64, 128).numpy(),
        np.asarray(jax.random.uniform(jax.random.PRNGKey(11), (64, 128), minval=lo, maxval=1.0)))


# ------------------------------------------------------------------- trees
def test_converted_trees_and_pack_params_bytes():
    """The reference's trees carried across unchanged; the port's
    ``pack_params`` of the float tree equals the reference's packed tree
    byte for byte (one s_X a layer); the port's own init has the
    reference's structure and shapes."""
    params, packed, tparams, tpacked = _models()
    _same_leaves(tparams, params, "float tree")
    _same_leaves(tpacked, packed, "packed tree")
    ours = tptq.pack_params({k: v for k, v in tparams.items() if k != "codebooks"}, TCB, TCfg())
    ours["codebooks"] = TCB
    _same_leaves(ours, packed, "pack_params")
    assert ours["dec_layers"]["xattn"]["wk"]["kernel_packed"]["s_x"].shape == (CFG.n_layers,)
    _, trt = _rts("none")
    drawn = tzoo.build(TCFG, trt, device="cpu").init(0)
    drawn["codebooks"] = TCB
    got = {jax.tree_util.keystr(p): tuple(a.shape)
           for p, a in jax.tree_util.tree_flatten_with_path(params)[0]}
    want = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}['{k}']")
            else:
                want[f"{path}['{k}']"] = tuple(v.shape)

    walk(drawn, "")
    assert want == got
    assert float(drawn["dec_layers"]["ln_x"]["scale"].min()) == 1.0
    assert float(drawn["enc_layers"]["mlp"]["wi"]["kernel"].std()) == pytest.approx(
        D ** -0.5, rel=0.05)


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("mode", ["none", "packed"])
def test_attention_branches(mode):
    """``attention``'s new branches against the reference's on decoder
    layer 1: bidirectional self-attention, cross-attention to given K/V
    (q alone projected), and the per-row decode over a bcq4 cache (two
    rows at their own positions): outputs, and the cache bytes."""
    jrt, trt = _rts(mode)
    jp, tp = _pick(mode)
    jl, tl = _layer(jp["dec_layers"], 1), ttr._layer(tp["dec_layers"], 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    want, _ = jax.jit(lambda x, p, pos: jlayers.attention(
        x, p, CFG, jrt, CB, pos, causal=False, use_rope=False))(x, jl["attn"], pos)
    got, _ = tlayers.attention(_t(x), tl["attn"], TCFG, trt, TCB, _t(pos), causal=False,
                               use_rope=False)
    _close(got, want, mode, "bidirectional")
    kv = [rng.normal(size=(2, T, CFG.n_kv_heads, CFG.head_dim)).astype(np.float32)
          for _ in range(2)]
    want, _ = jax.jit(lambda x, p, pos, k, v: jlayers.attention(
        x, p, CFG, jrt, CB, pos, causal=False, kv_override=(k, v), use_rope=False))(
        x, jl["xattn"], pos, *kv)
    got, _ = tlayers.attention(_t(x), tl["xattn"], TCFG, trt, TCB, _t(pos), causal=False,
                               kv_override=tuple(map(_t, kv)), use_rope=False)
    _close(got, want, mode, "cross")
    # per-row decode over a cache holding a 9-token prefill
    jc = jlayers.cache_init(2, ML, CFG.n_kv_heads, CFG.head_dim, "bcq4", JCfg())
    _, jc = jax.jit(lambda x, p, pos, c: jlayers.attention(
        x, p, CFG, jrt, CB, pos, cache=c, cache_pos=0, use_rope=False))(x, jl["attn"], pos, jc)
    tc = from_numpy_tree(_np(jc))
    x1 = rng.normal(size=(2, 1, D)).astype(np.float32)
    rows = np.array([9, 4], np.int32)
    want, jc = jax.jit(lambda x, p, r, c: jlayers.attention(
        x, p, CFG, jrt, CB, r[:, None], cache=c, cache_pos=r, use_rope=False))(
        x1, jl["attn"], rows, jc)
    got, out = tlayers.attention(_t(x1), tl["attn"], TCFG, trt, TCB, _t(rows)[:, None],
                                 cache=tc, cache_pos=_t(rows), use_rope=False)
    assert out is tc  # in place
    _close(got, want, mode, "per-row decode")
    _same_leaves(tc, jc, "per-row cache bytes")


# ------------------------------------------------------------ whole model
# The functions whose W4A4 launches part between the packages at
# ``packed`` on this file's inputs (``_first_flip``): the two prefills, where
# an f32 sum-order difference (a few ulps) in the attention over the
# dequantized bcq4 self cache moves the encode of the out-projection's
# activation, and every launch after it sees other inputs.
W4A4_FLIPS = {"prefill", "prefill_with_xkv"}


@contextlib.contextmanager
def _w4a4_inputs():
    """Record the activation of every fused W4A4 launch, in launch order:
    the port's as it calls ``layers.fused_packed_linear``, the reference's
    through an ordered debug callback (its functions stay jitted)."""
    got, ref = [], []
    t_real, j_real = tlayers.fused_packed_linear, jlayers.fused_packed_linear

    def t_rec(x, pk, rt, cb, s_x=None):
        got.append(x.detach().float().reshape(-1, x.shape[-1]).numpy().copy())
        return t_real(x, pk, rt, cb, s_x)

    def j_rec(x, pk, rt, cb, s_x=None):
        jax.debug.callback(lambda v: ref.append(np.asarray(v, np.float32).reshape(
            -1, v.shape[-1])), x, ordered=True)
        return j_real(x, pk, rt, cb, s_x)

    tlayers.fused_packed_linear, jlayers.fused_packed_linear = t_rec, j_rec
    try:
        yield got, ref
    finally:
        tlayers.fused_packed_linear, jlayers.fused_packed_linear = t_real, j_real


def _first_flip(got, ref, what):
    """The first launch whose activation LO-BCQ-encodes to other codes in
    the two packages (the port's encode of each: E4M3 ratio codes,
    selectors or indices; an s_X one ulp apart moves no code and only
    scales the launch's output by an ulp), or None.  Up to and at that
    launch each activation must be the reference's within 1e-5 of its
    max|x|: a flip is f32 noise crossing an encode boundary, never a wrong
    input."""
    assert len(got) == len(ref), (what, len(got), len(ref))
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, (what, i)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), (what, i, np.abs(a - b).max())
        ea, eb = (tbcq.encode(torch.from_numpy(v.copy()), TCB, TCfg()) for v in (a, b))
        if not all(torch.equal(getattr(ea, f), getattr(eb, f))
                   for f in ("scale_code", "packed_sel", "packed_idx")):
            return i
    return None


def _ref_inputs():
    frames, tokens = _inputs()
    return frames, tokens, np.roll(tokens, -1, 1), np.array([[3], [77]], np.int32)


@functools.lru_cache(maxsize=None)
def _reference_run(mode):
    """The reference's functions on the file's inputs, one jitted program
    (numpy results), and the activation of each W4A4 launch: the serving
    half publishes frames 1 into page 2 and frames 0 into page 3 of a
    4-page pool, and two rows at their own positions (9, 5) read pages 3
    and 2."""
    jrt, _ = _rts(mode)
    jp, _ = _pick(mode)
    frames, tokens, labels, nxt = _ref_inputs()
    pos = np.broadcast_to(np.arange(tokens.shape[1])[None], tokens.shape).astype(np.int32)

    def run(p):
        out = {"encode": jenc.encode(p, frames, CFG, jrt)}
        out["cross_kv"] = jenc._cross_kv(p, out["encode"], CFG, jrt, CB)
        out["decoder"] = jenc.decoder(p, tokens, out["encode"], CFG, jrt, pos)[0]
        out["loss"] = jenc.forward_train(p, {"frames": frames, "tokens": tokens,
                                             "labels": labels}, CFG, jrt)
        out["prefill"] = jenc.prefill(p, {"frames": frames, "tokens": tokens}, CFG, jrt, ML)
        out["decode_step"] = jenc.decode_step(p, out["prefill"][1], nxt, jnp.int32(9), CFG, jrt)
        one = jenc.encode_xkv(p, frames[1:], CFG, jrt)
        pool = jenc.enc_store(jenc.enc_pool_init(4, CFG, jrt), one, 2)
        out["encode_xkv"] = one
        out["enc_store"] = jenc.enc_store(pool, jenc.encode_xkv(p, frames[:1], CFG, jrt), 3)
        out["decode_step_shared"] = jenc.decode_step_shared(
            p, {"self": out["prefill"][1]["self"]}, nxt, jnp.asarray([9, 5], jnp.int32),
            out["enc_store"], jnp.asarray([3, 2], jnp.int32), CFG, jrt)
        xkv = tuple(leaf[2][:, None] for leaf in out["enc_store"])
        out["prefill_with_xkv"] = jenc.prefill_with_xkv(p, {"tokens": tokens[1:]}, CFG, jrt,
                                                         ML, xkv)
        return out

    with _w4a4_inputs() as (_, xs):
        out = jax.jit(run)(jp)
        jax.effects_barrier()
    return jax.tree.map(np.asarray, out), xs


def _port_run(mode, ref):
    """The port's functions, each on the reference's inputs to it (its
    caches and pool carried across), and each one's W4A4 activations."""
    _, trt = _rts(mode)
    _, tp = _pick(mode)
    frames, tokens, labels, nxt = map(_t, _ref_inputs())
    pos = torch.arange(tokens.shape[1])[None].expand(tokens.shape)
    caches = lambda: {"self": from_numpy_tree(ref["prefill"][1]["self"]),  # noqa: E731
                      "xkv": tuple(map(_t, ref["prefill"][1]["xkv"]))}
    pool = lambda: tuple(map(_t, ref["enc_store"]))  # noqa: E731
    fns = {
        "encode": lambda: tenc.encode(tp, frames, TCFG, trt),
        "cross_kv": lambda: tenc._cross_kv(tp, _t(ref["encode"]), TCFG, trt, TCB),
        "decoder": lambda: tenc.decoder(tp, tokens, _t(ref["encode"]), TCFG, trt, pos)[0],
        "loss": lambda: tenc.forward_train(tp, {"frames": frames, "tokens": tokens,
                                                "labels": labels}, TCFG, trt),
        "prefill": lambda: tenc.prefill(tp, {"frames": frames, "tokens": tokens}, TCFG, trt, ML),
        "decode_step": lambda: tenc.decode_step(tp, caches(), nxt, 9, TCFG, trt),
        "encode_xkv": lambda: tenc.encode_xkv(tp, frames[1:], TCFG, trt),
        "enc_store": lambda: tenc.enc_store(
            tenc.enc_store(tenc.enc_pool_init(4, TCFG, trt), tuple(map(_t, ref["encode_xkv"])), 2),
            tenc.encode_xkv(tp, frames[:1], TCFG, trt), 3),
        "decode_step_shared": lambda: tenc.decode_step_shared(
            tp, {"self": caches()["self"]}, nxt, torch.tensor([9, 5], dtype=torch.int32), pool(),
            torch.tensor([3, 2], dtype=torch.int32), TCFG, trt),
        "prefill_with_xkv": lambda: tenc.prefill_with_xkv(
            tp, {"tokens": tokens[1:]}, TCFG, trt, ML, tuple(leaf[2][:, None] for leaf in pool())),
    }
    out, xs = {}, {}
    for name, fn in fns.items():
        with _w4a4_inputs() as (got, _):
            out[name] = fn()
        xs[name] = got
    return out, xs


def _held(got, want, mode, what):
    """Outputs (tensors, tuples, dicts of caches) against the reference's:
    integer leaves (a bcq4 cache's bytes) equal, float leaves within the
    mode's tolerance."""
    if isinstance(got, dict):
        assert got.keys() == want.keys(), what
        for k in got:
            _held(got[k], want[k], mode, f"{what}[{k!r}]")
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want), what
        for k, (a, b) in enumerate(zip(got, want)):
            _held(a, b, mode, f"{what}[{k}]")
    elif got.dtype.is_floating_point:
        _close(got, want, mode, what)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("mode", ["none", "packed"])
def test_model_functions_match_reference(mode):
    """``encode``, ``_cross_kv``, ``decoder``, the ``forward_train`` loss,
    ``prefill`` (logits, self-cache bytes, cross K/V), the scalar
    ``decode_step``, and the serving half — ``encode_xkv``, ``enc_store``
    into a page pool, the per-row ``decode_step_shared`` over it and
    ``prefill_with_xkv`` against a page — each on the reference's inputs,
    held to the reference's outputs; at ``packed`` every W4A4 launch's
    activation is held up to the function's first launch whose encode
    parts (``_first_flip``), and the outputs of a function with such a
    launch (``W4A4_FLIPS``) are not compared."""
    ref, ref_xs = _reference_run(mode)
    got, got_xs = _port_run(mode, ref)
    flips, k = set(), 0
    for name in got:
        n = len(got_xs[name])
        flip = _first_flip(got_xs[name], ref_xs[k:k + n], name)
        k += n
        if flip is not None:
            flips.add(name)
            continue
        _held(got[name], ref[name], mode, name)
    assert k == len(ref_xs)
    if mode == "none":
        assert k == 0 and not flips
    else:
        assert flips == W4A4_FLIPS, flips


def test_decode_matches_parallel():
    """The cache decode (self KV + the encoder's cross K/V) equals the
    parallel teacher-forced decoder over the same encoder output (the
    reference's ``test_decode_matches_parallel_whisper``, on the port;
    bf16 cache as there)."""
    trt = TRuntime(quant_mode="none", compute_dtype=torch.float32)
    tp = _models()[2]
    frames, tokens = _inputs(b=1, s=16, seed=7)
    frames, tokens = _t(frames), _t(tokens)
    enc = tenc.encode(tp, frames, TCFG, trt)
    h, _ = tenc.decoder(tp, tokens, enc, TCFG, trt, torch.arange(16)[None])
    full = ttr.lm_logits(tp, h, trt)
    api = tzoo.build(TCFG, trt, device="cpu")
    lg, caches = api.prefill_fn(tp, {"tokens": tokens[:, :8], "frames": frames}, 16)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 7].numpy(), rtol=5e-3, atol=5e-3)
    for t in range(8, 16):
        lg, caches = api.decode_fn(tp, caches, tokens[:, t:t + 1], t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), rtol=5e-3, atol=5e-3)


# -------------------------------------------------------------------- zoo
def test_zoo_serves_encdec():
    """``encdec`` is served, through the state layout with shared encoder
    pages; ``vlm`` is built without a page spec, and both engines refuse
    it.  The API's serving half has the reference's shapes, and ``init``
    packs every GEMM of both stacks."""
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.state_engine import StatePagedEngine

    assert "encdec" in tzoo.SERVED_FAMILIES and "vlm" not in tzoo.SERVED_FAMILIES
    vlm = tzoo.build(t_get_smoke("pixtral_12b"), TRuntime(), device="cpu")
    assert vlm.page_spec is None
    for engine in (PagedEngine, StatePagedEngine):
        with pytest.raises(tzoo.UnsupportedModelError, match="family 'vlm'"):
            engine(vlm, vlm.init(0), n_slots=2, max_len=16, page_size=8, device="cpu")
    _, trt = _rts("packed")
    api = tzoo.build(TCFG, trt, device="cpu")
    assert api.page_spec == tzoo.PageSpec("state_checkpoint", shared_encoder=True)
    live = api.live_cache_init(3, ML, device="meta")
    assert live["self"]["k_idx"].shape == (CFG.n_layers, 3, ML, CFG.n_kv_heads,
                                           CFG.head_dim // 2)
    pool = api.enc_pool_init(5)
    assert len(pool) == 2 and pool[0] is not pool[1]
    assert pool[0].shape == (5, CFG.n_layers, T, CFG.n_kv_heads, CFG.head_dim)
    params = api.init(0)
    for stack in ("enc_layers", "dec_layers"):
        for name in ("wq", "wk", "wv", "wo"):
            pk = params[stack]["attn"][name]["kernel_packed"]
            assert "inv_scale" in pk and pk["s_x"].shape == (CFG.n_layers,)
    assert "kernel_packed" in params["dec_layers"]["xattn"]["wq"]
    assert params["codebooks"].shape == TCB.shape and "lm_head" not in params
