"""Port parity for the held-out evaluation forward: the synthetic token
stream, the flash-attention plain version and wrapper, and the loss of
the smoke gpt3_126m, each against the JAX package.

Tolerances, each with its reason:

* tokens: equal (both are the same numpy computation);
* flash attention: ``rtol = atol = 2e-4``, as tests/test_flash_kernel.py
  — the softmax and the two dot products sum in another order;
* loss: ``rtol = 1e-4``, as tests/test_flash_kernel.py — f32 summation
  order of every matmul, norm and softmax over two layers.  In W4A4 the
  encode is bit-identical on the CPU (tests/test_torch_numerics.py), so
  the same tolerance holds.

The JAX side runs its Pallas flash kernel with ``interpret=True``, as its
own tests do.  The CUDA kernel itself is held to the plain version on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke
from repro.core import ptq as jptq
from repro.core.bcq import BCQConfig as JCfg
from repro.core.calibrate import default_universal_codebooks
from repro.data import pipeline as jdata
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import zoo as jzoo
from repro.models.layers import Runtime as JRuntime
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime

CFG, TCFG = get_smoke("gpt3_126m"), t_get_smoke("gpt3_126m")


# ------------------------------------------------------------------ tokens
@pytest.mark.parametrize("seed,step,hosts", [(0, 0, (1, 0)), (0, 1_000_001, (1, 0)),
                                             (3, 7, (1, 0)), (1, 5, (2, 1))])
def test_tokens_match_reference(seed, step, hosts):
    n_hosts, host_id = hosts
    kw = dict(vocab=CFG.vocab, seq_len=96, global_batch=4, seed=seed, n_hosts=n_hosts,
              host_id=host_id)
    jc, tc = jdata.DataConfig(**kw), tdata.DataConfig(**kw)
    want = jdata.synth_tokens(jc, step)
    np.testing.assert_array_equal(tdata.synth_tokens(tc, step), want)
    jb = jdata.batch_at(jc, step)
    tb = tdata.batch_at(tc, step, device="cpu")
    for name in ("tokens", "labels"):
        assert tb[name].dtype == torch.int64 and tb[name].is_contiguous()
        np.testing.assert_array_equal(tb[name].numpy(), np.asarray(jb[name]))


def test_eval_stream_is_the_held_out_range():
    tc = tdata.DataConfig(vocab=CFG.vocab, seq_len=32, global_batch=2)
    jc = jdata.DataConfig(vocab=CFG.vocab, seq_len=32, global_batch=2)
    got = list(tdata.eval_stream(tc, 2, device="cpu"))
    want = list(jdata.eval_stream(jc, 2))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))
        np.testing.assert_array_equal(g["labels"].numpy(), np.asarray(w["labels"]))


# ----------------------------------------------------------------- flash
def _qkv(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, hkv, hkv)]


@pytest.mark.parametrize("shape", [(2, 256, 4, 4, 64), (1, 384, 8, 8, 32), (2, 128, 6, 6, 128),
                                   (2, 128, 8, 2, 64)])  # the last: GQA
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference(shape, causal):
    b, s, h, hkv, d = shape
    q, k, v = _qkv(b, s, h, hkv, d, sum(shape))
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              interpret=True))
    before = tflash.FLASH_ATTENTION.count
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=causal)
    assert tflash.FLASH_ATTENTION.count == before  # the CPU branch launches nothing
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_masked_softmax_at_ragged_length(causal):
    """S = 200 is no multiple of the kernel's 64-row tiles (the reference
    wrapper cannot take it; the port's kernel must): the wrapper, GQA
    included, is held to a masked softmax written out in numpy."""
    qn, kn, vn = _qkv(2, 200, 4, 2, 32, 9)
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)), causal=causal)
    kx, vx = (np.repeat(a, 2, axis=2).astype(np.float64) for a in (kn, vn))
    s = np.einsum("bqhd,bkhd->bhqk", qn.astype(np.float64), kx) / np.sqrt(32)
    if causal:
        s = np.where(np.tril(np.ones((200, 200), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), vx)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_flash_plain_keeps_bf16():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 64, 2, 2, 64, 4))
    got = tflash.flash_attention_plain(q[0].transpose(0, 1).contiguous(),
                                       k[0].transpose(0, 1).contiguous(),
                                       v[0].transpose(0, 1).contiguous())
    want = tflash.flash_attention_plain(*(t[0].transpose(0, 1).float() for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------------ loss
@pytest.fixture(scope="module")
def weights():
    rt = JRuntime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32)
    params = jzoo.build(CFG, rt).init(jax.random.PRNGKey(0))
    cb = default_universal_codebooks(JCfg()).as_jnp()
    packed = jptq.pack_params(params, cb, JCfg())
    packed["codebooks"] = cb
    return params, packed


def _batch():
    dc = dict(vocab=CFG.vocab, seq_len=128, global_batch=2)
    return jdata.batch_at(jdata.DataConfig(**dc), 1_000_000), \
        tdata.batch_at(tdata.DataConfig(**dc), 1_000_000, device="cpu")


@pytest.mark.parametrize("quant_mode", ["none", "packed"])
def test_loss_matches_reference_through_flash(weights, quant_mode):
    params = weights[0] if quant_mode == "none" else weights[1]
    jrt = JRuntime(quant_mode=quant_mode, compute_dtype=jnp.float32, param_dtype=jnp.float32,
                   flash_kernel=True)
    trt = TRuntime(quant_mode=quant_mode, compute_dtype=torch.float32, flash_kernel=True)
    jb, tb = _batch()
    want = float(jzoo.build(CFG, jrt).loss_fn(params, jb))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, params))
    api = tzoo.build(TCFG, trt, device="cpu")
    got = float(api.loss_fn(tparams, tb))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the flash path and the masked-softmax path are the same function
    plain = tzoo.build(TCFG, dataclasses.replace(trt, flash_kernel=False), device="cpu")
    np.testing.assert_allclose(float(plain.loss_fn(tparams, tb)), got, rtol=1e-5)


def test_chunked_logits_give_the_same_loss(weights):
    """logit_chunk > 0 takes the logits 32 positions at a time (and a
    mask), on both packages."""
    jb, tb = _batch()
    mask = (np.arange(128)[None, :] % 3 != 0).astype(np.float32).repeat(2, 0)
    jb, tb = dict(jb, mask=jnp.asarray(mask)), dict(tb, mask=torch.from_numpy(mask))
    tparams = from_numpy_tree(jax.tree.map(np.asarray, weights[0]))
    losses = []
    for chunk in (0, 32):
        trt = TRuntime(quant_mode="none", compute_dtype=torch.float32, logit_chunk=chunk)
        losses.append(float(tzoo.build(TCFG, trt, device="cpu").loss_fn(tparams, tb)))
    jrt = JRuntime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32,
                   logit_chunk=32)
    want = float(jzoo.build(CFG, jrt).loss_fn(weights[0], jb))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    np.testing.assert_allclose(losses[1], want, rtol=1e-4)
