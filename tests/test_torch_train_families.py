"""Training of the MoE, SSM, hybrid and enc-dec families against the JAX
package, on the CPU: the loss and every gradient leaf, and three
``make_train_step`` steps, under ``quant_mode`` ``none`` and ``fake`` (the
train CLI's ``--quant`` choices), on each family's smoke config:

* ``moonshot_v1_16b`` (MoE: 8 experts, top-2; the loss carries the
  router's 0.01 · load-balance aux term, and its gradient the router's);
* ``mamba2_130m`` (SSM: the SSD scan's backward);
* ``recurrentgemma_9b`` (hybrid: the RG-LRU scan's backward and local
  attention), on 40 tokens, past its window of 32, so the local mask is
  inside the gradient;
* ``whisper_base`` (enc-dec: the encoder over a ``frames`` batch of
  seeded normals · 0.02, the decoder's self and cross attention).

Weights come from one ``jax.random`` draw on the reference side (its
training tree: ``init`` plus, under ``fake``, the universal codebooks as a
float leaf, as its train CLI builds it), carried across by
``convert.from_numpy_tree``; tokens and frames from a numpy seed.  The
tolerances and the step rule are the dense test's
(``tests/test_torch_train.py``): the loss within rtol 1e-5, each gradient
leaf within ``GRAD_RTOL`` · max|g| of the leaf, and three steps at rtol
1e-5 / atol 1e-6 wherever Adam's update is well conditioned, within 2 ·
Σ lr elsewhere.  ``W4A4_FLIPS`` names the leaves that part otherwise,
each with its reason.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.launch import train as ttrain
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.optim import adamw as tadamw
from test_torch_train import GRAD_RTOL, RTOL, STEPS_LR, _at, _hold_steps, _paths
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

# (arch, batch, tokens a row): the hybrid past its window of 32
ARCHS = (("moonshot_v1_16b", 2, 16), ("mamba2_130m", 2, 24), ("recurrentgemma_9b", 2, 40),
         ("whisper_base", 2, 16))
MODES = ("none", "fake")
# (arch, mode, leaf name) held within 2 · Σ lr after three steps, as the
# dense test holds ("fake", "codebooks"): trained codebooks can near-tie
# two codebooks' block errors, and XLA sums a block's squared errors in
# another order than the port (ROADMAP C), so a selector can flip and move
# that block's share of the codebook gradient to another codebook.
W4A4_FLIPS = {(arch, "fake", "codebooks") for arch, _, _ in ARCHS}
# (arch, mode) whose third step end to end parts from the reference's past
# the dense test's rule → the rtol its third loss and grad_norm are held
# to; every leaf is then held within 2 · Σ lr, and each step from the
# reference's state at the full rule all the same.  Measured when written:
# * fake: the trained codebooks' near-ties (``W4A4_FLIPS``) move the
#   codebooks after step 2 (by 4.2e-4, 1.7e-4, 4.7e-4), and step 3's
#   forward quantizes with them: its loss parts by 1.1e-5, 1.6e-5, 4.5e-4
#   and its grad_norm by 9.7e-6, 2.9e-5, 2.5e-4;
# * the hybrid at ``none``: the embedding rows Adam leaves ill-conditioned
#   at step 1 (near-zero gradients, held within 2 · lr) part by up to
#   4.9e-5 and enter step 2's forward; after step 3, 10 of the embedding's
#   9,434 well-conditioned elements part by up to 3.7e-6 (loss 8.7e-8).
END_TO_END = {("mamba2_130m", "fake"): 1e-4, ("recurrentgemma_9b", "fake"): 1e-4,
              ("whisper_base", "fake"): 1e-3, ("recurrentgemma_9b", "none"): RTOL}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
    import jax.numpy as jnp

    from repro.configs.base import get_smoke
    from repro.core.calibrate import default_universal_codebooks as ref_books
    from repro.launch.train import make_train_step
    from repro.models import zoo
    from repro.models.layers import Runtime
    from repro.optim import adamw

    return SimpleNamespace(jax=jax, jnp=jnp, get_smoke=get_smoke, ref_books=ref_books,
                           make_train_step=make_train_step, zoo=zoo, Runtime=Runtime,
                           adamw=adamw)


_MODELS = {}


def _model(ref, arch, b, s, mode):
    """The reference's api, training tree and batch, and the port's on the
    same numbers (built once per (arch, mode))."""
    if (arch, mode) in _MODELS:
        return _MODELS[arch, mode]
    cfg = ref.get_smoke(arch)
    rt = ref.Runtime(quant_mode=mode, compute_dtype=ref.jnp.float32, param_dtype=ref.jnp.float32)
    api = ref.zoo.build(cfg, rt)
    params = api.init(ref.jax.random.PRNGKey(0))
    if mode != "none":
        params["codebooks"] = ref.ref_books(rt.bcq_cfg).as_jnp()
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        nb["frames"] = (rng.normal(size=(b, cfg.encoder_len, cfg.d_model)) * 0.02).astype(
            np.float32)
    tapi = tzoo.build(t_get_smoke(arch), TRuntime(quant_mode=mode, compute_dtype=torch.float32),
                      device="cpu")
    m = _MODELS[arch, mode] = SimpleNamespace(
        cfg=cfg, api=api, params=params, tapi=tapi,
        vg=ref.jax.jit(ref.jax.value_and_grad(api.loss_fn)),
        rstep=ref.jax.jit(ref.make_train_step(api, ref.adamw.AdamWConfig(**STEPS_LR))),
        tparams=from_numpy_tree(ref.jax.tree.map(np.asarray, params)),
        jb={k: ref.jnp.asarray(v) for k, v in nb.items()},
        tb={k: torch.from_numpy(v) for k, v in nb.items()})
    return m


CASES = pytest.mark.parametrize("arch, b, s", ARCHS, ids=[a for a, _, _ in ARCHS])


@pytest.mark.parametrize("mode", MODES)
@CASES
def test_loss_and_gradients_match_reference(ref, arch, b, s, mode):
    """``value_and_grad`` of the port's loss against ``jax.value_and_grad``
    of the reference's, every leaf (the MoE router's through its softmax,
    top-k gates and the aux term; under ``fake`` the codebooks too)."""
    m = _model(ref, arch, b, s, mode)
    loss, grads = m.vg(m.params, m.jb)
    tloss, tgrads = ttrain.value_and_grad(m.tapi.loss_fn, m.tparams, m.tb)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=RTOL)
    names = _paths(ref, grads)
    assert [p for p, _ in names] == [p for p, _ in _paths(ref, m.params)]
    for path, want in names:
        got = _at(tgrads, path).numpy()
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=str(path))
    if arch == "moonshot_v1_16b":  # the router learns (through the gates and the aux term)
        assert any("router" in path and np.abs(g).max() > 0 for path, g in names)


def _carry(ref, tree):
    """A reference tree (params, or AdamW's state) as the port's tensors."""
    return from_numpy_tree(ref.jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("mode", MODES)
@CASES
def test_three_train_steps_match_reference(ref, arch, b, s, mode):
    """Three steps of the port's ``make_train_step`` against the reference's
    under ``jax.jit``, two ways:

    * each step from the reference's own state (its params and moments
      carried across): loss, grad_norm and lr at rtol 1e-5, then params
      and moments by the dense test's rule on that step's conditioning
      (within 2 · lr where it is ill-conditioned) — the step function held
      on identical inputs at every step;
    * the three steps end to end, each package on its own state: loss,
      grad_norm and lr of each step at rtol 1e-5, params and moments after
      the first step and after the third by the dense test's rule —
      except for the cases ``END_TO_END`` names, whose third step is held
      within 2 · Σ lr (params and moments) and the rtol it names (loss,
      grad_norm).  The first step's two ways are one run (the same
      inputs)."""
    m = _model(ref, arch, b, s, mode)
    tstep = ttrain.make_train_step(m.tapi, tadamw.AdamWConfig(**STEPS_LR))
    jp, jo = m.params, ref.adamw.init_state(m.params)
    tp, to = m.tparams, tadamw.init_state(m.tparams)
    flips = {(mode, leaf) for a, md, leaf in W4A4_FLIPS if a == arch and md == mode}
    loose = (arch, mode) in END_TO_END
    lr_sum, cond, gmax = 0.0, {}, {}
    for step in range(3):
        g_step = {path: float(np.abs(g).max()) for path, g in _paths(ref, m.vg(jp, m.jb)[1])}
        gmax = {path: max(gmax.get(path, 0.0), g) for path, g in g_step.items()}
        forced = (_carry(ref, jp), _carry(ref, jo)) if step else None  # the reference's state
        jp, jo, jm = m.rstep(jp, jo, m.jb)
        tp, to, tm = tstep(tp, to, m.tb)
        fp, fo, fm = tstep(*forced, m.tb) if step else (tp, to, tm)
        lr = float(jm["lr"])
        lr_sum += lr
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(fm[name]), float(jm[name]), rtol=RTOL,
                                       err_msg=f"step {step + 1} from the reference's state: {name}")
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=END_TO_END[arch, mode] if loose and step == 2 else RTOL,
                                       err_msg=f"step {step + 1} end to end: {name}")
        bc2 = 1 - ref.adamw.AdamWConfig().b2 ** (step + 1)
        scale = {path: np.sqrt(v / np.float32(bc2)) for path, v in _paths(ref, jo["v"])}
        cond = {path: v if path not in cond else np.minimum(cond[path], v)
                for path, v in scale.items()}
        want = (jp, jo["m"], jo["v"])
        _hold_steps(ref, mode, want, (fp, fo["m"], fo["v"]), scale, g_step, lr,
                    flips if step else set(), f"step {step + 1} from the reference's state")
    every = {(mode, path[-1]) for path, _ in _paths(ref, jp)} if loose else flips
    n_ill = _hold_steps(ref, mode, want, (tp, to["m"], to["v"]), cond, gmax, lr_sum, every,
                        "step 3 end to end")
    n_all = sum(int(np.prod(v.shape)) for v in ref.jax.tree.leaves(want))
    assert int(to["step"]) == 3 and (loose or n_ill < n_all)
