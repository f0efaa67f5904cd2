"""Port parity for the two-launch W4A4 GEMM (``ops.quantize`` →
``ops.matmul``, ``ops.w4a4_linear``) against the JAX package, whose side
runs both its interpret-mode Pallas kernels (``impl="pallas"``) and its
oracles (``impl="ref"``).

Tolerances, each with its reason:

* quantize: packed bytes equal — or, where a block ties between two
  codebooks, decoded values equal (the contract of
  tests/test_kernels.py:3-6); E4M3 ratios and inverse scales exactly
  equal;
* matmul and the two-launch linear: ``rtol = 1e-5, atol = 1e-5·max|ref|``
  — both operands decode bit-identically, only the f32 sum order over K
  differs.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the parity side; absent where only the port runs

from repro.core.bcq import BCQConfig as JCfg
from repro.core.calibrate import default_universal_codebooks
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.core import bcq as tbcq
from repro_torch.kernels import bcq_matmul as tmatmul
from repro_torch.kernels import bcq_quantize as tquant
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.convert import from_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

JC, TC = JCfg(), tbcq.BCQConfig()
CB = default_universal_codebooks(JC).levels
M, K, N = 64, 256, 48


def _t(a):
    return torch.from_numpy(np.array(a))


def _activation(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[..., :: max(1, shape[-1] // 8)] *= 12.0  # outlier channels
    x.reshape(-1, shape[-1])[0, :64] = 0.0  # an all-zero array: s_A falls back to s_X
    return x


def _weight(n, k, seed):
    w = (np.random.default_rng(seed).standard_normal((k, n)) * k**-0.5).astype(np.float32)
    pk = jlayers.pack_weight(jnp.asarray(w), JC, jnp.asarray(CB))
    pk = {n_: np.asarray(v) for n_, v in pk.items()}
    return jops.packed_operand({a: jnp.asarray(b) for a, b in pk.items()}), \
        tops.packed_operand(from_numpy_tree(pk))


def _decode(idx, sel, inv):
    return tref.decode_ref(_t(idx), _t(sel), _t(inv), _t(CB), TC).numpy()


@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_quantize_matches_reference(impl):
    x = _activation((M, K), 1)
    want = jops.quantize(jnp.asarray(x), jnp.asarray(CB), JC, impl=impl)
    w_idx = np.asarray(want.idx_packed)[:M, : K // 2]
    w_sel = np.asarray(want.sel_packed)[:M, : K // 16]
    w_inv = np.asarray(want.inv_scale)[:M, : K // 64]
    before = tquant.BCQ_QUANTIZE.count
    got = tops.quantize(_t(x), _t(CB), TC)
    assert tquant.BCQ_QUANTIZE.count == before  # the CPU branch launches nothing
    assert got.k == K
    np.testing.assert_array_equal(got.inv_scale.numpy(), w_inv)
    same = np.array_equal(got.idx_packed.numpy(), w_idx) and \
        np.array_equal(got.sel_packed.numpy(), w_sel)
    if not same:  # a codebook tie: the decoded values must still agree
        np.testing.assert_array_equal(
            _decode(got.idx_packed, got.sel_packed, w_inv), _decode(w_idx, w_sel, w_inv))


def test_quantize_ratio_is_the_reference_ratio():
    x = _activation((M, K), 2)
    s_x = np.float32(31.0) / np.float32(np.abs(x).max())
    want = jref.quantize_ref(jnp.asarray(x), jnp.asarray(CB), JC, jnp.float32(s_x))
    got = tquant.bcq_quantize(_t(x), _t(CB), torch.tensor(s_x), TC)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_matmul_matches_reference(impl):
    x = _activation((M, K), 3)
    jw, tw = _weight(N, K, 4)
    ja = jops.quantize(jnp.asarray(x), jnp.asarray(CB), JC, impl=impl)
    want = np.asarray(jops.matmul(ja, jw, jnp.asarray(CB), JC, impl=impl))
    before = tmatmul.BCQ_MATMUL.count
    got = tops.matmul(tops.quantize(_t(x), _t(CB), TC), tw, _t(CB), TC).numpy()
    assert tmatmul.BCQ_MATMUL.count == before
    assert got.shape == (M, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_two_launch_linear_matches_reference(impl):
    x = _activation((2, 16, K), 5)  # leading axes flatten into M
    jw, tw = _weight(N, K, 6)
    want = np.asarray(jops.w4a4_linear(jnp.asarray(x), jw, jnp.asarray(CB), JC, impl=impl))
    got = tops.w4a4_linear(_t(x), tw, _t(CB), TC)
    assert got.shape == (2, 16, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_two_launch_linear_equals_fused_on_cpu():
    """Same encode, same decodes, same f32 matmul: on the CPU the two
    routes give the same numbers."""
    x = _t(_activation((37, 192), 7))
    _, tw = _weight(100, 192, 8)
    np.testing.assert_array_equal(tops.w4a4_linear(x, tw, _t(CB), TC).numpy(),
                                  tops.w4a4_linear_fused(x, tw, _t(CB), TC).numpy())


def test_two_launch_linear_refuses_ragged_k():
    _, tw = _weight(8, 128, 9)
    with pytest.raises(ValueError, match="multiple of L_A"):
        tops.quantize(torch.zeros(4, 100), _t(CB), TC)
    with pytest.raises(ValueError, match="K=64"):
        tops.w4a4_linear(torch.zeros(4, 64), tw, _t(CB), TC)
