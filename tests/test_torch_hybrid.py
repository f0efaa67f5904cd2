"""The port's RG-LRU hybrid (``repro_torch/models/hybrid.py``), its config,
its zoo branch, and the windowed attention and per-row ring writes it
adds to ``layers.py``, against the
JAX package, on the ``recurrentgemma_9b`` smoke (3 layers = 1 period; d
128, 4 heads of 32, 1 KV head, window 32, lru_width 128) and the same at 5
layers (1 period + 2 tail blocks, the full config's 12 + 2 in small).

Weights are the reference's (one ``jax.random`` draw, carried across by
``convert.from_numpy_tree``; the reference's packed tree built by its own
``pack_params`` with ``lm_head`` left float, the layout its packed forward
reads); activations are numpy-seeded; the reference's functions run
jitted (a compile costs less than the same ops one by one).  Tolerances, f32 throughout:

* ``_lru_scan``: rtol 1e-5, atol 1e-6 · max|ref| against the reference's
  ``associative_scan`` (the same association; XLA on the CPU may fuse
  ``ur + ar·ul`` into one multiply-add), and 1e-5 against a float64
  sequential recurrence;
* ``_conv``: 1e-6 relative, the carried state exactly; ``_attend_chunked``
  with a window: 1e-5 relative (another f32 summation order);
* ``cache_write_rows``: the bytes of every cache kind equal;
* ``rec_block`` / ``attn_block`` and the whole model (``forward_train``
  loss, ``prefill`` logits and states, decode logits past the window; the
  smoke at ``packed``, 5 layers at ``none``): rtol 1e-4, atol 1e-4 ·
  max|ref| (the loss 1e-5 relative); bf16 ring entries within one bf16 ulp; bcq4 ring bytes
  equal (a codebook tie would move a selector; none occurs on these
  inputs);
* ``pack_params`` bytes and the converted trees: equal;
* decode ≡ parallel in the port itself (``tests/test_model_math.py``'s
  wraparound check): rtol 5e-3, atol 5e-3, as the reference's.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import HybridSpec as THybridSpec
from repro_torch.configs.base import get_arch as t_get_arch
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.models import hybrid as thyb
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models import zoo as tzoo
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import pages as tpages

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.core.bcq import BCQConfig as JCfg  # noqa: E402
from repro.core.calibrate import default_universal_codebooks  # noqa: E402
from repro.models import hybrid as jhyb  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro_torch.core import ptq as tptq  # noqa: E402
from repro_torch.core.bcq import BCQConfig as TCfg  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402

ARCH = "recurrentgemma_9b"
CFG, TCFG = get_smoke(ARCH), t_get_smoke(ARCH)
W = CFG.hybrid.window  # 32
CB = default_universal_codebooks(JCfg()).as_jnp()
TCB = torch.from_numpy(np.array(CB))


def _cfgs(n_layers):
    if n_layers == CFG.n_layers:
        return CFG, TCFG
    return (dataclasses.replace(CFG, n_layers=n_layers),
            dataclasses.replace(TCFG, n_layers=n_layers))


def _rts(mode, kind="bcq4"):
    return (JRuntime(quant_mode=mode, compute_dtype=jnp.float32, param_dtype=jnp.float32,
                     cache_kind=kind),
            TRuntime(quant_mode=mode, compute_dtype=torch.float32, cache_kind=kind))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-4, rel_atol=1e-4, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel_atol * np.abs(want).max(),
                               err_msg=what)


def _no_lm_head(path, leaf):
    return jptq._is_gemm_weight(path, leaf) and "lm_head" not in path


@functools.lru_cache(maxsize=None)
def _models(n_layers=3):
    """(float params, packed params) of the reference at 5 layers, both with
    the codebooks (a bcq4 ring reads them at any quant_mode), and the
    port's copies of both; at 3 layers the same trees without the tail
    blocks (one reference draw serves both depths)."""
    if n_layers == 3:
        return tuple({k: v for k, v in t.items() if not k.startswith("tail")}
                     for t in _models(5))
    cfg, _ = _cfgs(n_layers)
    jrt, _ = _rts("none")
    params = jax.jit(jzoo.build(cfg, jrt).init)(jax.random.PRNGKey(0))
    packed = jax.jit(lambda p: jptq.pack_params(p, CB, JCfg(), predicate=_no_lm_head))(params)
    params["codebooks"] = packed["codebooks"] = CB
    return params, packed, from_numpy_tree(_np(params)), from_numpy_tree(_np(packed))


def _pick(mode, n_layers=3):
    params, packed, tparams, tpacked = _models(n_layers)
    return (packed, tpacked) if mode == "packed" else (params, tparams)


def _period_block(tree, name):
    return jax.tree.map(lambda a: a[0], tree["periods"][name])


def _t_period_block(tree, name):
    return ttr._layer(tree["periods"][name], 0)


def _same_leaves(t_tree, j_tree, exact=True, what=""):
    tl, jl = tpages.tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        b = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16 else b)
        assert a.shape == b.shape, what
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            _close(a, b, what=what)


def _ring_close(t_cache, j_cache, kind, what):
    """A ring after the same writes in both packages: ``pos_buf`` and the
    scalar s_X equal; bf16 entries within one bf16 ulp; int8 and bcq4
    bytes equal."""
    np.testing.assert_array_equal(t_cache["pos_buf"].numpy(), np.asarray(j_cache["pos_buf"]))
    for n, leaf in t_cache.items():
        if n == "pos_buf":
            continue
        want = np.asarray(j_cache[n].astype(jnp.float32) if j_cache[n].dtype == jnp.bfloat16
                          else j_cache[n])
        got = leaf.float().numpy() if leaf.dtype == torch.bfloat16 else leaf.numpy()
        assert got.shape == want.shape, (what, n)
        if leaf.ndim < 2 or kind == "bf16":
            np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6, err_msg=f"{what} {n}")
            continue
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {n}")


# ------------------------------------------------------------------ config
def test_config_is_the_references():
    import repro.configs.recurrentgemma_9b as jmod

    for ours, ref in ((t_get_arch(ARCH), jmod.CONFIG), (TCFG, CFG)):
        for f in dataclasses.fields(ours):
            got, want = getattr(ours, f.name), getattr(ref, f.name)
            if f.name == "hybrid":
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
    full = t_get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.head_dim, full.vocab) == (
        38, 4096, 12288, 256, 256000)
    assert full.tie_embeddings is False and full.hybrid.window == 2048
    assert dataclasses.asdict(THybridSpec()) == {"lru_width": 0, "window": 2048,
                                                 "pattern": ("rec", "rec", "attn")}
    assert thyb._counts(full) == (3, 12, 2) and thyb._counts(TCFG) == (3, 1, 0)


# -------------------------------------------------------------- primitives
def _sequential(a, u, state):
    h = np.zeros(a.shape[::2]) if state is None else state.astype(np.float64)
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + u[:, t]
        out.append(h)
    return np.stack(out, 1)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 5, 32, 37])
def test_lru_scan(s, with_state):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 24)).astype(np.float32)
    u = rng.normal(size=(2, s, 24)).astype(np.float32)
    state = rng.normal(size=(2, 24)).astype(np.float32) if with_state else None
    want = np.asarray(jax.jit(jhyb._lru_scan)(jnp.asarray(a), jnp.asarray(u),
                                              None if state is None else jnp.asarray(state)))
    got = thyb._lru_scan(_t(a), _t(u), None if state is None else _t(state))
    _close(got, want, rtol=1e-5, rel_atol=1e-6)
    _close(got, _sequential(a.astype(np.float64), u.astype(np.float64), state), rtol=1e-5,
           rel_atol=1e-6)
    if s == 1 and with_state:  # u + a · state, in that order
        assert torch.equal(got[:, 0], _t(u[:, 0]) + _t(a[:, 0]) * _t(state))


@pytest.mark.parametrize("with_state", [False, True])
def test_conv(with_state):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    kernel = rng.normal(size=(4, 16)).astype(np.float32)
    state = rng.normal(size=(2, 3, 16)).astype(np.float32) if with_state else None
    jy, js = jax.jit(jhyb._conv)(jnp.asarray(x), jnp.asarray(kernel),
                                 None if state is None else jnp.asarray(state))
    ty, ts = thyb._conv(_t(x), _t(kernel), None if state is None else _t(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_attend_chunked_window():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 40, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 40, 1, 32)).astype(np.float32)
    v = rng.normal(size=(2, 40, 1, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40)[None], (2, 40)).astype(np.int32)
    want = jax.jit(lambda *a: jlayers._attend_chunked(*a, 40, True, W, 1024))(
        *map(jnp.asarray, (q, k, v, pos)))
    got = tlayers._attend_chunked(*map(_t, (q, k, v, pos)), 40, window=W)
    _close(got, want, rtol=1e-5, rel_atol=1e-5)
    # the window bites: the last query sees keys 8..39 only
    nowin = tlayers._attend_chunked(*map(_t, (q, k, v, pos)), 40)
    assert not torch.allclose(nowin[:, -1], got[:, -1])
    assert torch.equal(nowin[:, :W], got[:, :W])


@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
def test_cache_write_rows_bytes(kind):
    rng = np.random.default_rng(3)
    k = rng.normal(size=(3, 1, 1, 32)).astype(np.float32)
    v = rng.normal(size=(3, 1, 1, 32)).astype(np.float32)
    rows = np.array([5, 31, 0], np.int32)
    jc = jlayers.cache_init(3, W, 1, 32, kind, JCfg())
    tc = tlayers.cache_init(3, W, 1, 32, kind, TCfg())
    jc = jax.jit(lambda c, *a: jlayers.cache_write_rows(c, *a, kind, JCfg(), CB))(
        jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(rows))
    out = tlayers.cache_write_rows(tc, _t(k), _t(v), _t(rows), kind, TCfg(), TCB)
    assert out is tc  # in place
    _same_leaves(tc, jc, what=kind)
    assert int((tc[sorted(tc)[0]].reshape(3, W, -1) != 0).any(-1).sum()) == 3  # one slot a row


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("mode", ["none", "packed"])
@pytest.mark.parametrize("cached", [False, True])
def test_rec_block(mode, cached):
    jp_all, tp_all = _pick(mode)
    jrt, trt = _rts(mode)
    rng = np.random.default_rng(4)
    s = 1 if cached else 20
    x = rng.normal(size=(2, s, CFG.d_model)).astype(np.float32)
    cache = None
    if cached:
        cache = {"lru_state": rng.normal(size=(2, 128)).astype(np.float32),
                 "conv_state": rng.normal(size=(2, 3, 128)).astype(np.float32)}
    jy, jc = jax.jit(lambda x, p, c: jhyb.rec_block(x, p, CFG, jrt, CB, c))(
        jnp.asarray(x), _period_block(jp_all, "b0"),
        None if cache is None else jax.tree.map(jnp.asarray, cache))
    tc = None if cache is None else {k: _t(v) for k, v in cache.items()}
    ty = thyb.rec_block(_t(x), _t_period_block(tp_all, "b0"), TCFG, trt, TCB, tc)
    _close(ty, jy)
    if cached:
        for n in jc:
            _close(tc[n], jc[n], what=n)


def _attn_inputs(branch, rng):
    s = {"free": 20, "prefill": 40}.get(branch, 1)
    x = rng.normal(size=(2, s, CFG.d_model)).astype(np.float32)
    if branch in ("free", "prefill"):
        pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)
        return x, pos, 0
    if branch == "rows":  # each row at its own position, one past the wraparound
        cpos = np.array([40, 33], np.int32)
        return x, cpos[:, None], cpos
    return x, np.full((2, 1), 40, np.int32), 40


def _ref_attn(mode, kind, x, pos, cache=None, cache_pos=None):
    """The reference's period-0 ``attn_block``, jitted (``cache_pos``, an
    int or a numpy (B,) vector, closed over as the engine passes it)."""
    jrt, _ = _rts(mode, kind)
    return jax.jit(lambda x, p, pos, c: jhyb.attn_block(x, p, CFG, jrt, CB, pos, c, cache_pos))(
        jnp.asarray(x), _period_block(_pick(mode)[0], "b2"), jnp.asarray(pos), cache)


@functools.lru_cache(maxsize=None)
def _prefilled_ring(mode, kind):
    """The reference's ring after a 40-token prefill of period 0's
    attention block (numpy leaves)."""
    jrt, _ = _rts(mode, kind)
    x, pos, _ = _attn_inputs("prefill", np.random.default_rng(6))
    return _np(_ref_attn(mode, kind, x, pos, jhyb.window_cache_init(2, CFG, jrt), 0)[1])


@pytest.mark.parametrize("mode, kind", [("none", "bf16"), ("packed", "bcq4")])
@pytest.mark.parametrize("branch", ["free", "prefill", "rows", "scalar"])
def test_attn_block(branch, mode, kind):
    """Every branch of ``attn_block`` at ``none`` with a bf16 ring and at
    ``packed`` with a bcq4 ring (the served configuration); the decode
    branches start from the reference's ring after a 40-token prefill
    (the keep-the-last-window path: slots 8..39 hold positions 40 % 32 …)."""
    jrt, trt = _rts(mode, kind)
    tp = _t_period_block(_pick(mode)[1], "b2")
    rng = np.random.default_rng(5)
    x, pos, cpos = _attn_inputs(branch, rng)
    if branch == "free":
        jy, _ = _ref_attn(mode, kind, x, pos)
        ty = thyb.attn_block(_t(x), tp, TCFG, trt, TCB, _t(pos))
        _close(ty, jy)
        return
    jcache = (jhyb.window_cache_init(2, CFG, jrt) if branch == "prefill"
              else jax.tree.map(jnp.asarray, _prefilled_ring(mode, kind)))
    tcache = from_numpy_tree(_np(jcache))
    jy, jc = _ref_attn(mode, kind, x, pos, jcache, cpos)
    ty = thyb.attn_block(_t(x), tp, TCFG, trt, TCB, _t(pos), tcache,
                         _t(cpos) if branch == "rows" else cpos)
    _close(ty, jy, what=branch)
    _ring_close(tcache, jc, kind, f"{branch} {mode} {kind}")
    if branch == "prefill":  # slots (40 - 32 + j) % 32 hold positions 8..39
        assert sorted(tcache["pos_buf"][0].tolist()) == list(range(8, 40))
        assert tcache["pos_buf"][0, 0].item() == 32


# ------------------------------------------------------------------- model
@functools.lru_cache(maxsize=None)
def _jitted(n_layers, mode):
    """The reference's loss, prefill and per-row decode, jitted once each
    (a decode step eagerly costs as much as its compile)."""
    cfg, _ = _cfgs(n_layers)
    japi = jzoo.build(cfg, _rts(mode)[0])
    return (jax.jit(japi.loss_fn), jax.jit(lambda p, t: japi.prefill_fn(p, {"tokens": t}, 64)),
            jax.jit(japi.decode_fn))


@pytest.mark.parametrize("n_layers, mode", [(3, "packed"), (5, "none")])
def test_model_matches_reference(n_layers, mode):
    """``forward_train`` loss, a 40-token prefill (past the window) and two
    per-row decode steps, with a bcq4 ring: logits, the LRU and conv
    states and the rings."""
    cfg, tcfg = _cfgs(n_layers)
    _, trt = _rts(mode)
    jp, tp = _pick(mode, n_layers)
    jloss, jprefill, jdecode = _jitted(n_layers, mode)
    tapi = tzoo.build(tcfg, trt, device="cpu")
    rng = np.random.default_rng(7 + n_layers)
    tok = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jl = float(jloss(jp, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}))
    tl = float(tapi.loss_fn(tp, {"tokens": _t(tok), "labels": _t(lab)}))
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)

    jlg, jc = jprefill(jp, jnp.asarray(tok))
    tlg, tc = tapi.prefill_fn(tp, {"tokens": _t(tok)}, 64)
    _close(tlg, jlg, what="prefill")
    for step in range(2):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        pos = np.array([40 + step, 41 + 2 * step], np.int32)
        jlg, jc = jdecode(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tlg, tc = tapi.state_decode_fn(tp, tc, _t(nxt), _t(pos))
        _close(tlg, jlg, what=f"decode {step}")
    for name in tc["periods"]:
        if "pos_buf" in tc["periods"][name]:
            for p in range(tc["periods"][name]["pos_buf"].shape[0]):
                _ring_close({n: leaf[p] for n, leaf in tc["periods"][name].items()},
                            {n: leaf[p] for n, leaf in jc["periods"][name].items()}, "bcq4",
                            f"period {p} {name}")
        else:
            for n, leaf in tc["periods"][name].items():
                _close(leaf, jc["periods"][name][n], what=f"{name} {n}")
    for t in range(n_layers - 3 * (n_layers // 3)):
        for n, leaf in tc[f"tail{t}"].items():
            _close(leaf, jc[f"tail{t}"][n], what=f"tail{t} {n}")


@pytest.mark.parametrize("kind", ["bf16", "bcq4"])
def test_decode_equals_parallel_past_the_window(kind):
    """tests/test_model_math.py's wraparound check on the port (bf16 ring):
    prefill 8, then decode one token at a time to position 40 through the
    ring, each step's logits equal to the teacher-forced parallel
    forward's.  At either ring kind the same steps per row (a (B,)
    position vector) give the contiguous path's logits bit for bit."""
    _, trt = _rts("none", kind)
    tp = _models()[2]
    tapi = tzoo.build(TCFG, trt, device="cpu")
    tok = _t(np.random.default_rng(8).integers(0, CFG.vocab, (1, 40)).astype(np.int32))
    x = ttr.embed_tokens(tp, tok, trt)
    full = ttr.lm_logits(tp, thyb.hybrid_backbone(tp, x, TCFG, trt, thyb._positions(1, 40, "cpu")),
                         trt)
    lg, c = tapi.prefill_fn(tp, {"tokens": tok[:, :8]}, 40)
    _, cr = tapi.prefill_fn(tp, {"tokens": tok[:, :8]}, 40)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 7].numpy(), rtol=5e-3, atol=5e-3)
    for t in range(8, 40):
        lg, c = tapi.decode_fn(tp, c, tok[:, t:t + 1], t)
        lr, cr = tapi.state_decode_fn(tp, cr, tok[:, t:t + 1], torch.tensor([t]))
        if kind == "bf16":  # a bcq4 ring's K/V are quantized, the parallel forward's not
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), rtol=5e-3,
                                       atol=5e-3, err_msg=f"position {t} (window {W})")
        assert torch.equal(lr, lg), t
    for a, b in zip(tpages.tree_leaves(c), tpages.tree_leaves(cr)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ trees
def test_pack_params_bytes_match_reference():
    """The (P, K, N) period stacks pack with one s_X a period, byte for byte
    the reference's ``pack_params`` (its vmap over 3-D leaves), a tail
    block's 2-D kernels with one each; ``lm_head``, the conv kernel, the
    norms and ``lru_a`` stay float."""
    params, packed, tparams, _ = _models(5)
    ours = tptq.pack_params({k: v for k, v in tparams.items() if k != "codebooks"}, TCB, TCfg())
    flat = jax.tree_util.tree_flatten_with_path({k: v for k, v in packed.items()
                                                 if k != "codebooks"})[0]
    assert len(flat) == len(tpages.tree_leaves(ours))
    for path, leaf in flat:
        node = ours
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    per = ours["periods"]
    assert per["b0"]["gate_a"]["kernel_packed"]["s_x"].shape == (1,)
    assert ours["tail1"]["mlp"]["wo"]["kernel_packed"]["s_x"].shape == ()
    assert set(ours["lm_head"]) == {"kernel"} and per["b1"]["lru_a"].dtype == torch.float32
    assert per["b0"]["conv_kernel"].shape == (1, 4, 128)


def test_convert_carries_the_reference_tree():
    params, packed, tparams, tpacked = _models(5)
    for j, t in ((params, tparams), (packed, tpacked)):
        flat = jax.tree_util.tree_flatten_with_path(j)[0]
        assert len(flat) == len(tpages.tree_leaves(t))
        for path, leaf in flat:
            node = t
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tparams["periods"]["b2"]["attn"]["wk"]["kernel"].shape == (1, 128, 32)
    assert set(tpacked) >= {"periods", "tail0", "tail1", "embed", "lm_head", "ln_f"}


# -------------------------------------------------------------------- zoo
def test_zoo_hybrid_branch_inits_period_by_period():
    """The hybrid branch: ``state_checkpoint`` pages; ``init`` draws each
    period and tail block from its own (seed, index) generator and packs
    it before the next (a deeper model's first period and first tail
    block… equal a shallower one's where the indices meet), ``lm_head``
    float; the live cache holds real per-period tensors (a write to one
    period leaves the others), ``pos_buf`` at −1."""
    _, trt = _rts("packed")
    api3 = tzoo.build(TCFG, trt, device="cpu")
    api8 = tzoo.build(dataclasses.replace(TCFG, n_layers=8), trt, device="cpu")
    assert api3.page_spec == tzoo.PageSpec("state_checkpoint")
    p3, p8 = api3.init(0), api8.init(0)
    a = p3["periods"]["b0"]["proj_x"]["kernel_packed"]
    b = p8["periods"]["b0"]["proj_x"]["kernel_packed"]
    assert b["idx"].shape[0] == 2 and b["s_x"].shape == (2,) and "inv_scale" in b
    for n in ("idx", "sel", "scale", "s_x", "inv_scale"):
        assert torch.equal(a[n][0], b[n][0]), n
    assert not torch.equal(b["idx"][0], b["idx"][1])
    assert torch.equal(p3["embed"]["kernel"], p8["embed"]["kernel"])
    assert set(p8["lm_head"]) == {"kernel"} and "codebooks" in p8
    assert set(p8) >= {"tail0", "tail1"} and "kernel_packed" in p8["tail1"]["gate_x"]
    live = api8.live_cache_init(3)
    ring = live["periods"]["b2"]
    assert ring["k_idx"].shape == (2, 3, W, 1, 16) and ring["k_sx"].shape == (2,)
    assert bool((ring["pos_buf"] == -1).all())
    for leaf in tpages.tree_leaves(live["periods"]):
        assert leaf.stride(0) != 0 or leaf.shape[0] == 1
    live["periods"]["b0"]["lru_state"][0].fill_(1.0)
    assert float(live["periods"]["b0"]["lru_state"][1].abs().sum()) == 0.0
    # the fake mode keeps the float stacks, fake-quantized
    pf = tzoo.build(TCFG, dataclasses.replace(trt, quant_mode="fake"), device="cpu").init(0)
    assert pf["periods"]["b0"]["proj_x"]["kernel"].shape == (1, 128, 128)
