"""The port's model in the reference's fake-quant W4A4 modes against the JAX
package: ``quant_mode`` ``fake`` (weights PTQ'd offline by
``ptq.quantize_params``, activations quantized in the forward) and
``fake_full`` (the weights quantized in the forward too), under every
``act_format`` (``bcq``, the baselines ``mx4`` / ``mxfp4`` / ``vsq`` /
``int4``, and ``none``), on the smoke ``gpt3_126m`` (the MoE family is
``tests/test_torch_ptq_moe.py``).

Weights come from one ``jax.random`` draw on the reference side, tokens
from a numpy seed.  Held: ``forward_train`` (loss, plus 0.01 · aux for
MoE) and the ``prefill`` logits within rtol = ``RTOL``, atol = ``RTOL`` ·
max|logits| — the encodes are bit-identical, the f32 matmuls, norms and
softmax sum in another order, and no case here parts by a W4A4 flip (so
none is named, unlike ``tests/test_torch_moe.py``'s ``W4A4_FLIPS``).
The quant-error probe fires in the fake modes as in the reference: the
same sites in the same order, NMSE within ``RTOL``, occupancy equal.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.core import bcq as tbcq
from repro_torch.core import ptq as tptq
from repro_torch.core.calibrate import default_universal_codebooks
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import ACT_FORMATS
from repro_torch.models.layers import Runtime as TRuntime

MODES = ("fake", "fake_full")
RTOL = 1e-5
CB = default_universal_codebooks()


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
    import jax.numpy as jnp

    from repro.configs.base import get_smoke
    from repro.core import ptq
    from repro.core.bcq import BCQConfig
    from repro.models import transformer, zoo
    from repro.models.layers import Runtime

    return SimpleNamespace(jax=jax, jnp=jnp, get_smoke=get_smoke, ptq=ptq, BCQConfig=BCQConfig,
                           transformer=transformer, zoo=zoo, Runtime=Runtime)


def build_model(ref, arch, seed):
    """The reference's trees of ``arch`` for each mode (``fake``: the PTQ'd
    float tree; ``fake_full``: the float tree), as jnp and as port tensors;
    a batch of tokens in both packages."""
    cb = ref.jnp.asarray(CB.levels)
    cfg = ref.get_smoke(arch)
    rt = ref.Runtime(quant_mode="none", compute_dtype=ref.jnp.float32,
                     param_dtype=ref.jnp.float32)
    floats = ref.zoo.build(cfg, rt).init(ref.jax.random.PRNGKey(seed))
    trees = {"fake": ref.ptq.quantize_params(floats, cb, ref.BCQConfig()),
             "fake_full": dict(floats)}
    for t in trees.values():
        t["codebooks"] = cb
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 17))
    return SimpleNamespace(
        cfg=cfg, tcfg=t_get_smoke(arch), trees=trees,
        ttrees={m: from_numpy_tree(ref.jax.tree.map(np.asarray, t)) for m, t in trees.items()},
        jb={"tokens": ref.jnp.asarray(toks[:, :-1]), "labels": ref.jnp.asarray(toks[:, 1:])},
        tb={"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])})


@pytest.fixture(scope="module")
def dense(ref):
    return build_model(ref, "gpt3_126m", 0)


def _close(got, want):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def check_mode(ref, m, mode, act_format):
    """``forward_train`` and the ``prefill`` logits of model ``m`` in
    ``mode`` under ``act_format``, port vs reference."""
    jrt = ref.Runtime(quant_mode=mode, compute_dtype=ref.jnp.float32,
                      param_dtype=ref.jnp.float32, act_format=act_format)
    trt = TRuntime(quant_mode=mode, compute_dtype=torch.float32, act_format=act_format)
    want = ref.transformer.forward_train(m.trees[mode], m.jb, m.cfg, jrt)
    got = ttf.forward_train(m.ttrees[mode], m.tb, m.tcfg, trt)
    _close(got, want)
    want_lg, _ = ref.transformer.prefill(m.trees[mode], {"tokens": m.jb["tokens"]}, m.cfg, jrt, 24)
    got_lg, _ = ttf.prefill(m.ttrees[mode], {"tokens": m.tb["tokens"]}, m.tcfg, trt, 24)
    _close(got_lg, want_lg)


@pytest.mark.parametrize("act_format", ACT_FORMATS)
@pytest.mark.parametrize("mode", MODES)
def test_fake_modes_match_reference(ref, dense, mode, act_format):
    check_mode(ref, dense, mode, act_format)


def test_zoo_fake_init_is_the_ptq_tree(dense):
    """``zoo.build`` in ``fake`` mode serves the offline-PTQ'd tree
    (``ptq.quantize_params``: a layer stack is one tensor with one s_X)."""
    from repro_torch.models import zoo as tzoo

    m = dense
    api = tzoo.build(m.tcfg, TRuntime(quant_mode="fake", compute_dtype=torch.float32),
                     device="cpu")
    params = api.init(3)
    floats = tzoo.build(m.tcfg, TRuntime(compute_dtype=torch.float32), device="cpu").init(3)
    want = tptq.quantize_params(floats, CB.as_tensor(), tbcq.BCQConfig())
    for name in ("wq", "wk", "wv", "wo"):
        assert torch.equal(params["layers"]["attn"][name]["kernel"],
                           want["layers"]["attn"][name]["kernel"])
    assert torch.equal(params["codebooks"], CB.as_tensor())


@pytest.mark.parametrize("mode", MODES)
def test_fake_modes_refuse_a_tree_without_codebooks(dense, mode):
    """A W4A4 mode on a tree without codebooks raises, where it would
    otherwise run every GEMM in float."""
    m = dense
    params = {k: v for k, v in m.ttrees[mode].items() if k != "codebooks"}
    trt = TRuntime(quant_mode=mode, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="needs the tree's 'codebooks'"):
        ttf.forward_train(params, m.tb, m.tcfg, trt)


class _Probe:
    """A recorder that keeps (site, nmse, occupancy) of every emission."""

    def __init__(self):
        self.rows = []

    def record(self, site, x, codebooks, cfg):
        nmse, occ = tbcq.encode_stats(x, codebooks, cfg)
        self.rows.append((site, float(nmse), occ.tolist()))


@pytest.mark.parametrize("mode", MODES)
def test_quant_probe_fires_in_fake_modes(ref, dense, mode):
    m = dense
    seen = []
    jrt = ref.Runtime(quant_mode=mode, compute_dtype=ref.jnp.float32,
                      param_dtype=ref.jnp.float32,
                      quant_probe=lambda tag, nmse, occ: seen.append(
                          (tag, float(nmse), np.asarray(occ).tolist())))
    ref.transformer.forward_train(m.trees[mode], m.jb, m.cfg, jrt)
    ref.jax.effects_barrier()
    probe = _Probe()
    trt = TRuntime(quant_mode=mode, compute_dtype=torch.float32, quant_probe=probe)
    ttf.forward_train(m.ttrees[mode], m.tb, m.tcfg, trt)
    assert [r[0] for r in probe.rows] == [s[0] for s in seen] and len(seen) == 4 * m.cfg.n_layers
    for (_, g_nmse, g_occ), (_, w_nmse, w_occ) in zip(probe.rows, seen):
        assert g_nmse == pytest.approx(w_nmse, rel=RTOL) and g_occ == w_occ
