"""The port's training path against the JAX package, on the CPU: AdamW
(``optim/adamw.py``), the ``Prefetcher``, the ``Watchdog``, the loss and
its gradient under ``quant_mode`` ``none`` and ``fake`` (W4A4 fake-quant
training, whose codebooks are a trained float leaf), three train steps,
remat, and the train CLI's resume.

Weights come from one ``jax.random`` draw on the reference side (its
training tree: ``init_lm`` plus the universal codebooks, as its train
CLI builds it), converted by ``models.convert``; tokens from a numpy
seed.  Tolerances:

* AdamW on identical inputs: params, moments, ``grad_norm`` and ``lr``
  within rtol 1e-5, atol 1e-6 (the reference's own, ``tests/test_system.py``;
  the same f32 operations, the pow and cosine of another libm);
* the loss within rtol 1e-5; each gradient leaf within ``GRAD_RTOL`` ·
  max|g| of the leaf (f32 sums of the backward in another order);
* three train steps end to end at the reference's tolerance, on every
  element whose Adam update is well conditioned: where the reference's
  sqrt(v̂) stays at or above 1e-3 · max|g| of the leaf at every step, a
  gradient that rounds differently (~1e-6 · max|g|) moves m̂ / (sqrt(v̂) +
  ε) by at most ~1e-3, so the update by at most lr · 1e-3 = atol.  Below
  that, Adam divides the gradients' rounding noise by a near-zero scale:
  those elements are held within 2 · Σ lr of the reference (what two
  opposite normalized steps can part by).  ``W4A4_FLIPS`` names the one
  case that parts otherwise.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.core import bcq as tbcq
from repro_torch.core.calibrate import default_universal_codebooks
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import elastic as telastic
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

RTOL, ATOL = 1e-5, 1e-6  # tests/test_system.py:64
GRAD_RTOL = 2e-5
ADAM_COND = 1e-3
STEPS_LR = dict(lr=1e-3, warmup_steps=2, total_steps=3)
CB = default_universal_codebooks()
# W4A4 fake-quant training after its first step: the codebooks are no
# longer integers, so two codebooks' block errors can lie within an ulp of
# each other; XLA sums a block's squared errors in another order than the
# port's left-to-right sum (ROADMAP C), so such a near-tie can pick another
# selector, which moves that block's share of the codebook gradient to
# another codebook.  The codebook leaf is held at the tolerance after the
# first step (integer books: every error sum exact) and within 2 · Σ lr
# after three.
W4A4_FLIPS = {("fake", "codebooks")}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
    import jax.numpy as jnp

    from repro.configs.base import get_smoke
    from repro.core import bcq
    from repro.core.calibrate import default_universal_codebooks as ref_books
    from repro.data import pipeline
    from repro.launch.train import make_train_step
    from repro.models import zoo
    from repro.models.layers import Runtime
    from repro.optim import adamw
    from repro.runtime import elastic

    return SimpleNamespace(jax=jax, jnp=jnp, get_smoke=get_smoke, bcq=bcq, ref_books=ref_books,
                           pipeline=pipeline, make_train_step=make_train_step, zoo=zoo,
                           Runtime=Runtime, adamw=adamw, elastic=elastic)


@pytest.fixture(scope="module")
def models(ref):
    """Per quant_mode: the reference's api, training tree and batch, and the
    port's on the same numbers."""
    cfg = ref.get_smoke("gpt3_126m")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 33)).astype(np.int32)
    out = {}
    for mode in ("none", "fake"):
        rt = ref.Runtime(quant_mode=mode, compute_dtype=ref.jnp.float32,
                         param_dtype=ref.jnp.float32)
        api = ref.zoo.build(cfg, rt)
        params = api.init(ref.jax.random.PRNGKey(0))
        if mode != "none":
            params["codebooks"] = ref.ref_books(rt.bcq_cfg).as_jnp()
        tapi = tzoo.build(t_get_smoke("gpt3_126m"),
                          TRuntime(quant_mode=mode, compute_dtype=torch.float32), device="cpu")
        out[mode] = SimpleNamespace(
            api=api, params=params, tapi=tapi,
            tparams=from_numpy_tree(ref.jax.tree.map(np.asarray, params)),
            jb={"tokens": ref.jnp.asarray(toks[:, :-1]), "labels": ref.jnp.asarray(toks[:, 1:])},
            tb={"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])})
    return out


def _paths(ref, tree):
    """(name, numpy leaf) of a reference tree, in its leaf order."""
    flat = ref.jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(k.key for k in path), np.asarray(leaf)) for path, leaf in flat]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------------ AdamW
def test_adamw_matches_reference_on_a_mixed_tree(ref):
    """``schedule`` over warmup, cosine and past the end, and three
    ``apply_updates`` on a tree with 2-D, 1-D, integer and ``codebooks``
    leaves and gradients large enough to clip, against the reference's
    jitted functions: params, m, v, step, grad_norm and lr."""
    cfg = tadamw.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=5)
    rcfg = ref.adamw.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=5)
    sched = ref.jax.jit(lambda s: ref.adamw.schedule(rcfg, s))
    for s in range(8):
        np.testing.assert_allclose(
            float(tadamw.schedule(cfg, torch.tensor(s, dtype=torch.int32))),
            float(sched(ref.jnp.asarray(s, ref.jnp.int32))), rtol=RTOL, atol=0)
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((6, 8)).astype(np.float32),
              "bias": rng.standard_normal(8).astype(np.float32),
              "codebooks": np.asarray(CB.levels, np.float32),
              "packed": rng.integers(0, 255, (4, 4)).astype(np.uint8)}
    jp = {k: ref.jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jo, to = ref.adamw.init_state(jp), tadamw.init_state(tp)
    upd = ref.jax.jit(lambda p, g, o: ref.adamw.apply_updates(p, g, o, rcfg))
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 2).astype(np.float32)
                 for k, v in params.items() if k != "packed"}
        jg = {**{k: ref.jnp.asarray(v) for k, v in grads.items()},
              "packed": ref.jnp.zeros((4, 4), ref.jnp.float32)}
        tg = {**{k: torch.from_numpy(v) for k, v in grads.items()}, "packed": None}
        jp, jo, jm = upd(jp, jg, jo)
        tp, to, tm = tadamw.apply_updates(tp, tg, to, cfg)
        assert float(jm["grad_norm"]) > rcfg.clip_norm  # the clip branch
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=RTOL, atol=0)
        assert int(to["step"]) == int(jo["step"]) == step + 1 and to["step"].dtype == torch.int32
        for k in params:
            for got, want in ((tp[k], jp[k]), (to["m"][k], jo["m"][k]), (to["v"][k], jo["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(tp["packed"], torch.from_numpy(params["packed"]))  # passed through
    assert tp["w"].dtype == torch.float32 and not torch.equal(tp["codebooks"], CB.as_tensor())


def test_apply_updates_is_out_of_place():
    """The arguments are left as they were (a preemption snapshot of the
    previous step stays whole while the next step runs)."""
    p = {"w": torch.ones((3, 4)), "b": torch.zeros(4)}
    o = tadamw.init_state(p)
    before = [t.clone() for t in tadamw.tree_leaves(p) + tadamw.tree_leaves(o)]
    g = {"w": torch.full((3, 4), 0.5), "b": torch.full((4,), -0.5)}
    new_p, new_o, _ = tadamw.apply_updates(p, g, o, tadamw.AdamWConfig())
    assert all(torch.equal(a, b) for a, b in
               zip(before, tadamw.tree_leaves(p) + tadamw.tree_leaves(o)))
    assert not torch.equal(new_p["w"], p["w"]) and int(new_o["step"]) == 1


# ------------------------------------------------------- data and watchdog
def test_prefetcher_order_and_bytes_match_reference(ref):
    cfg = tpipe.DataConfig(vocab=512, seq_len=24, global_batch=3, seed=4)
    rcfg = ref.pipeline.DataConfig(vocab=512, seq_len=24, global_batch=3, seed=4)
    pf = tpipe.Prefetcher(cfg, start_step=5)
    try:
        got = [next(iter(pf)) for _ in range(3)]
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert [s for s, _ in got] == [5, 6, 7]
    for step, batch in got:
        want = ref.pipeline.batch_at(rcfg, step)
        for k in ("tokens", "labels"):
            w = np.asarray(want[k])
            assert batch[k].numpy().dtype == w.dtype and batch[k].numpy().tobytes() == w.tobytes()


def test_watchdog_matches_reference(ref):
    """Stragglers and missing hosts on the same beats."""
    mine, theirs = telastic.Watchdog(n_hosts=5), ref.elastic.Watchdog(n_hosts=5)
    per_step = {0: 1.0, 1: 1.1, 2: 0.9, 3: 4.5}  # host 3 straggles, host 4 never beats
    for host, dt in per_step.items():
        for step in range(6):
            for w in (mine, theirs):
                w.beat(host, step, t=100.0 + dt * step)
    assert mine.step_times() == theirs.step_times()
    assert mine.stragglers() == theirs.stragglers() == [3]
    for now in (106.0, 130.0):
        assert mine.missing(5.0, now=now) == theirs.missing(5.0, now=now)
    assert mine.missing(5.0, now=106.0) == [4]


# -------------------------------------------------- the loss and gradients
@pytest.mark.parametrize("mode", ["none", "fake"])
def test_loss_and_gradients_match_reference(ref, models, mode):
    """``value_and_grad`` of the port's loss against ``jax.value_and_grad``
    of the reference's, every leaf — under ``fake`` the codebooks too (the
    gradient reaches them through the decode's gather, and x only through
    s_X: no straight-through estimator in either package)."""
    m = models[mode]
    loss, grads = ref.jax.jit(ref.jax.value_and_grad(m.api.loss_fn))(m.params, m.jb)
    tloss, tgrads = ttrain.value_and_grad(m.tapi.loss_fn, m.tparams, m.tb)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=RTOL)
    names = _paths(ref, grads)
    assert [p for p, _ in names] == [p for p, _ in _paths(ref, m.params)]
    for path, want in names:
        got = _at(tgrads, path).numpy()
        assert got.shape == want.shape and np.abs(want).max() > 0, path
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=str(path))


def _hold_steps(ref, mode, jtrees, ttrees, cond, gmax, lr_sum, flips, when):
    """Every leaf of the reference's (params, m, v) against the port's: at
    the tolerance where Adam's update is well conditioned and the leaf is
    not in ``flips``, within 2 · Σ lr elsewhere.  Returns the count of
    elements held within 2 · Σ lr only."""
    n_ill = 0
    for tree, ttree in zip(jtrees, ttrees):
        for path, want in _paths(ref, tree):
            got = _at(ttree, path).numpy()
            if (mode, path[-1]) in flips:
                well = np.zeros(want.shape, bool)
            else:
                well = cond[path] >= ADAM_COND * gmax[path]
            np.testing.assert_allclose(got[well], want[well], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{when} {path}")
            assert np.abs(got - want).max() <= 2 * lr_sum, (when, path)
            n_ill += int((~well).sum())
    return n_ill


@pytest.mark.parametrize("mode", ["none", "fake"])
def test_three_train_steps_match_reference(ref, models, mode):
    """Three steps of the port's ``make_train_step`` against the reference's
    under ``jax.jit``, end to end: loss, grad_norm and lr of each step,
    then params and moments after the first step (integer codebooks: no
    flip can part them) and after the third (tolerances in the module
    docstring)."""
    m = models[mode]
    rstep = ref.jax.jit(ref.make_train_step(m.api, ref.adamw.AdamWConfig(**STEPS_LR)))
    tstep = ttrain.make_train_step(m.tapi, tadamw.AdamWConfig(**STEPS_LR))
    grad_of = ref.jax.jit(ref.jax.grad(m.api.loss_fn))
    jp, jo, tp, to = m.params, ref.adamw.init_state(m.params), m.tparams, tadamw.init_state(
        m.tparams)
    lr_sum, cond, gmax = 0.0, {}, {}
    for step in range(3):
        for path, g in _paths(ref, grad_of(jp, m.jb)):
            gmax[path] = max(gmax.get(path, 0.0), float(np.abs(g).max()))
        jp, jo, jm = rstep(jp, jo, m.jb)
        tp, to, tm = tstep(tp, to, m.tb)
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=RTOL, err_msg=name)
        lr_sum += float(jm["lr"])
        bc2 = 1 - ref.adamw.AdamWConfig().b2 ** (step + 1)
        for path, v in _paths(ref, jo["v"]):
            scale = np.sqrt(v / np.float32(bc2))
            cond[path] = scale if path not in cond else np.minimum(cond[path], scale)
        trees = ((jp, jo["m"], jo["v"]), (tp, to["m"], to["v"]))
        if step == 0:
            _hold_steps(ref, mode, *trees, cond, gmax, lr_sum, set(), "step 1")
    n_ill = _hold_steps(ref, mode, *trees, cond, gmax, lr_sum, W4A4_FLIPS, "step 3")
    n_all = sum(int(np.prod(v.shape)) for v in ref.jax.tree.leaves((jp, jo["m"], jo["v"])))
    assert int(to["step"]) == 3 and n_ill < n_all


# ------------------------------------------------------------------- remat
@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("mode", ["none", "fake"])
def test_remat_equals_no_remat(models, monkeypatch, mode, policy):
    """``Runtime(remat=True)`` recomputes each layer in the backward
    (``remat_policy`` ``full``: nothing kept; ``dots``: the linears'
    outputs kept) and gives the loss and every gradient bit for bit."""
    from repro_torch.models import layers

    m = models[mode]
    rt = TRuntime(quant_mode=mode, compute_dtype=torch.float32, remat=True, remat_policy=policy)
    api = tzoo.build(t_get_smoke("gpt3_126m"), rt, device="cpu")
    calls, mlp = [0], layers.mlp

    def counted(*a, **k):
        calls[0] += 1
        return mlp(*a, **k)

    monkeypatch.setattr(layers, "mlp", counted)
    loss, grads = ttrain.value_and_grad(m.tapi.loss_fn, m.tparams, m.tb)
    plain_calls, calls[0] = calls[0], 0
    rloss, rgrads = ttrain.value_and_grad(api.loss_fn, m.tparams, m.tb)
    n_layers = t_get_smoke("gpt3_126m").n_layers
    assert plain_calls == n_layers and calls[0] == 2 * n_layers  # each layer run again
    assert torch.equal(loss, rloss)
    for a, b in zip(tadamw.tree_leaves(grads), tadamw.tree_leaves(rgrads)):
        assert torch.equal(a, b)


# ---------------------------------------------- the codebook premise, B1/B4/B5
def test_kernel_codebook_check_takes_trained_books_for_the_encode_only():
    """B3's quantize form takes any sorted, finite f32 levels and reports
    whether they are integers (its table) or not (its threshold search);
    B1, B4 and the page writer (``integer=True``) refuse non-integer
    levels with the message they always gave."""
    books = CB.as_tensor()
    assert tbcq.check_kernel_codebooks(books, tbcq.BCQConfig(), integer=False) is True
    drifted = books + torch.linspace(-3e-3, 2e-3, books.numel()).reshape(books.shape)
    assert tbcq.check_kernel_codebooks(drifted, tbcq.BCQConfig(), integer=False) is False
    with pytest.raises(ValueError, match="codebook levels must be integers"):
        tbcq.check_kernel_codebooks(drifted, tbcq.BCQConfig())
    wide = books * 2  # integers past ±31: no table, the threshold search
    assert tbcq.check_codebook_levels(wide.numpy(), tbcq.BCQConfig(), integer=False) is False
    for bad, msg in ((books.flip(-1), "sorted"), (books.clone().index_fill_(1, torch.tensor([3]),
                                                                            float("nan")),
                                                  "finite")):
        with pytest.raises(ValueError, match=f"codebook levels must be {msg}"):
            tbcq.check_kernel_codebooks(bad, tbcq.BCQConfig(), integer=False)


def test_fake_quant_on_trained_books_matches_reference(ref):
    """The plain encode on drifted (non-integer, sorted) codebooks — the
    kernel's contract that B3's threshold search is held to on the card —
    against the reference's ``bcq.fake_quant``, values equal bit for bit."""
    lv = np.asarray(CB.levels, np.float32)
    drifted = (lv + np.random.default_rng(7).uniform(-2e-3, 2e-3, lv.shape)).astype(np.float32)
    drifted = np.sort(drifted, axis=-1)
    x = (np.random.default_rng(8).standard_normal((6, 256)) * 3).astype(np.float32)
    got = tbcq.fake_quant(torch.from_numpy(x), torch.from_numpy(drifted), tbcq.BCQConfig())
    want = ref.bcq.fake_quant(ref.jnp.asarray(x), ref.jnp.asarray(drifted), ref.bcq.BCQConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernels_without_backward_refuse_inputs_that_require_grad():
    """B1, B4 and B5 have no backward (nor have the reference's Pallas
    calls): their wrappers raise, on either device, where autograd records
    and an input requires grad, instead of returning a result cut off from
    the graph; under ``torch.no_grad()`` they run."""
    from repro_torch.kernels import bcq_linear, bcq_matmul
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import quantize_ref
    from repro_torch.models import layers

    cfg, cb = tbcq.BCQConfig(), CB.as_tensor()
    x = torch.randn((4, 64), generator=torch.Generator().manual_seed(0))
    pw = layers.pack_weight(torch.randn((64, 8)), cfg, cb)
    from repro_torch.kernels import ops

    op = ops.packed_operand(pw)
    s_x = tbcq.tensor_scale(x, cfg)
    xg = x.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="bcq_linear has no backward"):
        bcq_linear.bcq_linear(xg, op.idx_packed, op.sel_packed, op.inv_scale, cb, s_x, cfg)
    with pytest.raises(RuntimeError, match="bcq_linear_experts has no backward"):
        bcq_linear.bcq_linear_experts(xg[None], op.idx_packed[None], op.sel_packed[None],
                                      op.inv_scale[None], cb, s_x, cfg)
    a_idx, a_sel, ratio = quantize_ref(x, cb, cfg, s_x)
    a_inv = (1.0 / (ratio * s_x)).requires_grad_()
    with pytest.raises(RuntimeError, match="bcq_matmul has no backward"):
        bcq_matmul.bcq_matmul(a_idx, a_sel, a_inv, op.idx_packed, op.sel_packed, op.inv_scale,
                              cb, cb, cfg)
    q = torch.randn((1, 8, 2, 32)).requires_grad_()
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        flash_attention(q, q, q)
    with torch.no_grad():
        out = bcq_linear.bcq_linear(xg, op.idx_packed, op.sel_packed, op.inv_scale, cb, s_x, cfg)
        assert out.shape == (4, 8) and flash_attention(q, q, q).shape == q.shape


# ----------------------------------------------------------------- the CLI
def _ckpt_leaves(path):
    from repro_torch.checkpoint.manager import CheckpointManager

    step, state = CheckpointManager(str(path)).restore()
    return step, tadamw.tree_leaves(state)


def test_train_cli_resume_is_bit_exact(tmp_path, capsys):
    """``launch.train.main`` on the CPU: 6 steps, then a rerun to 12 that
    resumes from step 6 ends bit-equal, in every leaf of params and
    optimizer state, to a straight 12-step run (the data is (seed,
    step)-pure and the step deterministic); ``--model-parallel 2`` on one
    rank builds a (1, 1) mesh and ends bit-equal to it too."""
    base = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32", "--log-every", "3",
            "--save-every", "4"]
    ttrain.main(base + ["--steps", "6", "--ckpt", str(tmp_path / "a")])
    ttrain.main(base + ["--steps", "12", "--ckpt", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "step 12 loss" in out
    ttrain.main(base + ["--steps", "12", "--ckpt", str(tmp_path / "b")])
    (sa, la), (sb, lb) = _ckpt_leaves(tmp_path / "a"), _ckpt_leaves(tmp_path / "b")
    assert sa == sb == 12 and len(la) == len(lb)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(la, lb))
    # --model-parallel on one rank: derive_mesh builds (1, 1), and the step is the same
    capsys.readouterr()
    ttrain.main(base + ["--steps", "12", "--model-parallel", "2", "--ckpt", str(tmp_path / "c")])
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    sc, lc = _ckpt_leaves(tmp_path / "c")
    assert sc == 12 and all(torch.equal(a, c) for a, c in zip(lb, lc))
