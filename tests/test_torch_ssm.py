"""The port's Mamba-2 SSD model (``repro_torch/models/ssm.py``), its config,
its zoo branch, the typed page kinds and the state-page tree ops, against
the JAX package, on the 2-layer ``mamba2_130m`` smoke (d 128, d_state 16,
head_dim 32, chunk 32).

Weights are the reference's (one ``jax.random`` draw, carried across by
``convert.from_numpy_tree``); activations are numpy-seeded.  Tolerances,
f32 throughout:

* ``_segsum``, ``_causal_conv`` and the softplus: 1e-6 relative (the same
  sums in the same order; XLA and torch may round a transcendental by an
  ulp), the mask's −inf positions exactly;
* ``ssd_chunked`` and ``ssm_block``: rtol 1e-4, atol 1e-4 · max|ref| — the
  einsums contract in another order, and the inter-chunk recurrence is a
  sequential loop here where the reference runs an associative scan;
* the model's prefill / decode logits and ``forward_train`` loss: rtol
  1e-4, atol 1e-4 · max|ref| (the loss 1e-5 relative), compounded over
  two layers; the same in the W4A4 ``packed`` mode, where the encodes are
  bit-identical and only the f32 sums' order differs;
* the packed bytes of ``pack_params`` and every state tree op: equal.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SSMSpec as TSSMSpec
from repro_torch.configs.base import get_arch as t_get_arch
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.models import ssm as tssm
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro.serving import pages as jpages  # noqa: E402
from repro_torch.core import ptq as tptq  # noqa: E402
from repro_torch.core.bcq import BCQConfig as TCfg  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402

ARCH = "mamba2_130m"
CFG, TCFG = get_smoke(ARCH), t_get_smoke(ARCH)
JRT = JRuntime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32)
TRT = TRuntime(quant_mode="none", compute_dtype=torch.float32)
CB = default_universal_codebooks(JCfg()).as_jnp()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-4, rel_atol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel_atol * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _models():
    """(float params, packed params) of the reference, and the port's
    copies of both."""
    params = jzoo.build(CFG, JRT).init(jax.random.PRNGKey(0))
    packed = jptq.pack_params(params, CB, JCfg())
    packed["codebooks"] = CB
    return params, packed, from_numpy_tree(_np(params)), from_numpy_tree(_np(packed))


def _packed_apis():
    jrt = dataclasses.replace(JRT, quant_mode="packed")
    trt = dataclasses.replace(TRT, quant_mode="packed")
    return jzoo.build(CFG, jrt), tzoo.build(TCFG, trt, device="cpu")


# ------------------------------------------------------------------ config
def test_config_is_the_references():
    import repro.configs.mamba2_130m as jmod

    for ours, ref in ((t_get_arch(ARCH), jmod.CONFIG), (TCFG, CFG)):
        for f in dataclasses.fields(ours):
            want = getattr(ref, f.name)
            got = getattr(ours, f.name)
            if f.name == "ssm":
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
    assert dataclasses.asdict(TSSMSpec()) == {"d_state": 128, "d_conv": 4, "expand": 2,
                                              "head_dim": 64, "chunk": 128}


# -------------------------------------------------------------- primitives
def test_segsum_keeps_the_minus_inf_mask():
    x = np.random.default_rng(0).normal(size=(3, 2, 7)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = tssm._segsum(_t(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    assert np.all(np.exp(got)[~fin] == 0.0)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(1)
    xbc = rng.normal(size=(2, 5, 12)).astype(np.float32)
    kernel = rng.normal(size=(4, 12)).astype(np.float32)
    state = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    jy, js = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(kernel),
                               None if state is None else jnp.asarray(state))
    ty, ts = tssm._causal_conv(_t(xbc), _t(kernel), None if state is None else _t(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))  # the last K-1 input rows


def test_softplus_is_logaddexp():
    x = np.array([-80.0, -20.0, -1.5, 0.0, 0.3, 19.0, 20.0, 25.0, 90.0], np.float32)
    np.testing.assert_allclose(tssm._softplus(_t(x)).numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)


def test_chunk_choice_mirrors_the_reference():
    s_cfg = t_get_arch(ARCH).ssm
    assert tssm._chunk_of(s_cfg, 500) == 4  # 128 → 64 → … → 4: 125 chunks
    assert tssm._chunk_of(s_cfg, 512) == 128
    assert tssm._chunk_of(s_cfg, 48) == 48
    assert tssm._chunk_of(s_cfg, 7) == 7


def _ssd_inputs(seed, bsz=2, s=32, h=3, p=4, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(bsz, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    b_in = rng.normal(size=(bsz, s, n)).astype(np.float32)
    c_in = rng.normal(size=(bsz, s, n)).astype(np.float32)
    return x * dt[..., None], dt, a, b_in, c_in


def _ssd_sequential(x, dt, a, b_in, c_in):
    """tests/test_model_math.py's token-by-token recurrence, in numpy f64."""
    bsz, s, h, p = x.shape
    state = np.zeros((bsz, h, p, b_in.shape[-1]))
    ys = []
    for t in range(s):
        state = state * np.exp(dt[:, t] * a[None, :])[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t], b_in[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", state, c_in[:, t]))
    return np.stack(ys, 1), state


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked(chunk):
    args = _ssd_inputs(chunk)
    jy, js = jax.jit(jssm.ssd_chunked, static_argnums=5)(*map(jnp.asarray, args), chunk)
    ty, ts = tssm.ssd_chunked(*map(_t, args), chunk)
    _close(ty, jy)
    _close(ts, js)
    sy, ss = _ssd_sequential(*(a.astype(np.float64) for a in args))
    _close(ty, sy)
    _close(ts, ss)


@pytest.mark.parametrize("decode", [False, True])
def test_ssm_block(decode):
    params, _, tparams, _ = _models()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 1 if decode else 20, CFG.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["mixer"])
    tp = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["layers"]["mixer"].items()}
    cache = None
    if decode:
        one = jssm.ssm_cache_init(2, CFG, JRT)
        cache = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in one.items()}
    block = jax.jit(lambda x, p, c: jssm.ssm_block(x, p, CFG, JRT, None, c))
    jy, jc = block(jnp.asarray(x), jp, None if cache is None else jax.tree.map(jnp.asarray, cache))
    ty, tc = tssm.ssm_block(_t(x), tp, TCFG, TRT, None,
                            None if cache is None else {k: _t(v) for k, v in cache.items()})
    _close(ty, jy)
    for k in jc:
        _close(tc[k], jc[k])


# ------------------------------------------------------------------- model
def test_forward_train_loss_and_logits():
    params, _, tparams, _ = _models()
    rng = np.random.default_rng(3)
    tok = rng.integers(0, CFG.vocab, (2, 40)).astype(np.int32)
    lab = rng.integers(0, CFG.vocab, (2, 40)).astype(np.int32)
    japi = jzoo.build(CFG, JRT)
    tapi = tzoo.build(TCFG, TRT, device="cpu")
    jl = float(japi.loss_fn(params, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}))
    tl = float(tapi.loss_fn(tparams, {"tokens": _t(tok), "labels": _t(lab)}))
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)


@pytest.mark.parametrize("mode", ["none", "packed"])
def test_prefill_then_decode_logits(mode):
    params, packed, tparams, tpacked = _models()
    if mode == "none":
        japi, tapi = jzoo.build(CFG, JRT), tzoo.build(TCFG, TRT, device="cpu")
        jp, tp = params, tparams
    else:
        (japi, tapi), jp, tp = _packed_apis(), packed, tpacked
    rng = np.random.default_rng(4)
    tok = rng.integers(0, CFG.vocab, (3, 21)).astype(np.int32)
    jl, jc = japi.prefill_fn(jp, {"tokens": jnp.asarray(tok)}, 64)
    tl, tc = tapi.prefill_fn(tp, {"tokens": _t(tok)}, 64)
    _close(tl, jl)
    for k in jc:
        _close(tc[k], jc[k])
    for step in range(3):
        nxt = rng.integers(0, CFG.vocab, (3, 1)).astype(np.int32)
        pos = np.full((3,), 21 + step, np.int32)
        jl, jc = japi.decode_fn(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = tapi.state_decode_fn(tp, tc, _t(nxt), _t(pos))
        _close(tl, jl)
    for k in jc:
        _close(tc[k], jc[k])


def test_pack_params_bytes_match_reference():
    """The (L, K, N) projection stacks pack with one s_X a layer, byte for
    byte the reference's ``pack_params`` (its vmap over 3-D leaves); the
    conv kernel, norms and embedding stay float."""
    params, packed, tparams, _ = _models()
    ours = tptq.pack_params(tparams, _t(CB), TCfg())
    flat = jax.tree_util.tree_flatten_with_path({k: v for k, v in packed.items()
                                                 if k != "codebooks"})[0]
    assert len(flat) == len(jax.tree.leaves(ours))
    for path, leaf in flat:
        node = ours
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    assert ours["layers"]["mixer"]["in_proj"]["kernel_packed"]["s_x"].shape == (CFG.n_layers,)
    assert set(ours["layers"]["mixer"]["out_proj"]) == {"kernel_packed"}
    assert ours["layers"]["mixer"]["conv_kernel"].dtype == torch.float32


def test_zoo_ssm_branch_and_what_is_left():
    tapi = tzoo.build(TCFG, dataclasses.replace(TRT, quant_mode="packed"), device="cpu")
    assert tapi.page_spec == tzoo.PageSpec("state_checkpoint")
    params = tapi.init(0)
    pk = params["layers"]["mixer"]["in_proj"]["kernel_packed"]
    di = 2 * TCFG.d_model
    n_in = 2 * di + 2 * TCFG.ssm.d_state + di // TCFG.ssm.head_dim
    assert pk["idx"].shape == (TCFG.n_layers, n_in, TCFG.d_model // 2)
    assert pk["inv_scale"].shape == (TCFG.n_layers, n_in, TCFG.d_model // 64)
    assert "codebooks" in params and params["layers"]["mixer"]["conv_kernel"].dtype == torch.float32
    np.testing.assert_allclose(params["layers"]["mixer"]["A_log"][1].numpy(),
                               np.log(np.arange(1, di // TCFG.ssm.head_dim + 1)), rtol=1e-7)
    assert torch.equal(params["layers"]["mixer"]["D"], torch.ones_like(params["layers"]["mixer"]["D"]))
    live = tapi.live_cache_init(3, device="meta")
    assert live["ssm_state"].shape == (TCFG.n_layers, 3, di // TCFG.ssm.head_dim,
                                       TCFG.ssm.head_dim, TCFG.ssm.d_state)
    dense = tzoo.build(t_get_smoke("gpt3_126m"), TRT, device="cpu")
    assert dense.page_spec == tzoo.PageSpec("kv_paged")
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.state_engine import StatePagedEngine

    vlm = tzoo.build(t_get_smoke("pixtral_12b"), TRT, device="cpu")  # built, not paged-servable
    assert vlm.page_spec is None
    for engine in (PagedEngine, StatePagedEngine):
        with pytest.raises(tzoo.UnsupportedModelError, match="family 'vlm'"):
            engine(vlm, vlm.init(0), n_slots=2, max_len=16, page_size=8, device="cpu")
    encdec = tzoo.build(t_get_smoke("whisper_base"), TRT, device="cpu")  # served now
    assert encdec.page_spec == tzoo.PageSpec("state_checkpoint", shared_encoder=True)


# ----------------------------------------------------------- typed pages
def test_page_kinds_are_typed():
    pool = tpages.PagePool(6)
    a, b = pool.alloc(tpages.KIND_STATE), pool.alloc()
    assert (pool.kind_of(a), pool.kind_of(b)) == ("state", "kv")
    assert pool.used_by_kind() == {"kv": 1, "state": 1, "shared_ro": 0}
    assert sum(pool.used_by_kind().values()) == pool.used()
    assert pool.deref(a)  # parked: keeps its kind
    assert pool.used_by_kind()["state"] == 1
    pool.revive(a)  # a revived page keeps its kind
    assert pool.kind_of(a) == "state" and pool.used_by_kind()["state"] == 1
    with pytest.raises(ValueError, match="not parked"):
        pool.revive(a)
    assert pool.deref(a)
    pool.release(a)
    assert pool.kind_of(a) is None and pool.used_by_kind()["state"] == 0
    with pytest.raises(ValueError, match="unknown page kind"):
        pool.alloc("weird")


# ---------------------------------------------------------- state tree ops
def _tree(seed, batch, pool=False, n_pages=5):
    """A family-like cache tree: two batch-axis leaves (axis 1 and 2, an
    int8 one) and a replicated scalar; as a pool, pages in front."""
    rng = np.random.default_rng(seed)
    if pool:
        return {"a": rng.normal(size=(n_pages, 2, 3)).astype(np.float32),
                "q": {"idx": rng.integers(-9, 9, (n_pages, 2, 4)).astype(np.int8),
                      "s": np.float32(0.5)}}
    return {"a": rng.normal(size=(2, batch, 3)).astype(np.float32),
            "q": {"idx": rng.integers(-9, 9, (2, 4, batch)).astype(np.int8),
                  "s": np.float32(0.5)}}


def _init_fn(batch, device="cpu"):
    return {"a": torch.zeros((2, batch, 3), device=device),
            "q": {"idx": torch.zeros((2, 4, batch), dtype=torch.int8, device=device),
                  "s": torch.tensor(0.5, device=device)}}


def _same(t_tree, j_tree):
    for tl, jl in zip(tpages.tree_leaves(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_state_tree_ops_match_reference():
    axes = tpages.state_batch_axes(lambda b: _init_fn(b, "meta"))
    assert axes == {"a": 1, "q": {"idx": 2, "s": tpages.REPLICATED}}
    jaxes = jpages.state_batch_axes(lambda b: jax.tree.map(jnp.asarray, _tree(0, b)))
    assert jax.tree.leaves(jaxes) == tpages.tree_leaves(axes)
    spool = tpages.state_pool_init(_init_fn, axes, 5)
    assert spool["a"].shape == (5, 2, 3) and spool["q"]["idx"].shape == (5, 2, 4)
    assert spool["q"]["s"].ndim == 0

    live_np, pool_np = _tree(1, 4), _tree(2, 0, pool=True)
    jlive, jpool = jax.tree.map(jnp.asarray, live_np), jax.tree.map(jnp.asarray, pool_np)
    tlive, tpool = from_numpy_tree(live_np), from_numpy_tree(pool_np)
    # rows 0 and 3 checkpoint, rows 1 and 2 go to the null page (last one wins)
    dsts = np.array([3, 0, 0, 2], np.int32)
    jpool = jpages.state_checkpoint_rows(jpool, jlive, jaxes, jnp.asarray(dsts))
    tpages.state_checkpoint_rows(tpool, tlive, axes, _t(dsts))
    _same(tpool, jpool)
    jlive = jpages.state_restore_row(jlive, jpool, jaxes, 1, 3)
    tpages.state_restore_row(tlive, tpool, axes, 1, 3)
    _same(tlive, jlive)
    _same(tpages.state_extract_row(tlive, axes, 2), jpages.state_extract_row(jlive, jaxes, 2))
    one = tpages.state_extract_row(tlive, axes, 0)
    jlive = jpages.state_insert_row(jlive, jax.tree.map(jnp.asarray, _np_tree(one)), jaxes, 3)
    tpages.state_insert_row(tlive, one, axes, 3)
    _same(tlive, jlive)
    jlive = jpages.state_copy_row(jlive, jaxes, 3, 1)
    tpages.state_copy_row(tlive, axes, 3, 1)
    _same(tlive, jlive)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


def test_state_page_round_trip_bitwise_with_replicated_leaf():
    """tests/test_host_tier.py's round trip on the port's movers: the
    replicated leaf does not travel, the arrays and their digest equal
    the reference's, the page comes back bit for bit."""
    axes = {"a": 1, "q": {"idx": 2, "s": tpages.REPLICATED}}
    pool_np = _tree(3, 0, pool=True)
    tpool = from_numpy_tree(pool_np)
    jpool = jax.tree.map(jnp.asarray, pool_np)
    src = tpages.state_page_fetch(tpool, axes, 1)
    ref = jpages.state_page_fetch(jpool, axes, 1)
    assert len(src) == len(ref) == 2
    for a, b in zip(src, ref):
        np.testing.assert_array_equal(a.numpy(), b)
    assert tpages.page_digest(src) == jpages.page_digest(ref)
    tier = tpages.HostPageTier(2)
    entry = tier.take(tier.put(src, tpages.KIND_STATE), expect_kind=tpages.KIND_STATE)
    tpages.state_page_insert(tpool, axes, entry.arrays, 4, flat=entry.flat)
    for a, b in zip(tpages.state_page_fetch(tpool, axes, 4), src):
        assert torch.equal(a, b)
    assert float(tpool["q"]["s"]) == 0.5
