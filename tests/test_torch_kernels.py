"""Port parity: the kernels' plain PyTorch versions against the JAX package,
and the oracles of both packages against each other.

Tolerances, each with its reason:

* fused linear: ``rtol=1e-5, atol=1e-5·max|ref|`` — the encode and both
  decodes are bit-identical, only the f32 sum order over K differs;
* page-gather attention: ``atol=rtol=2e-5``, as tests/test_paged_kernel.py
  — softmax and accumulation order differ;
* page bytes and oracle helpers: equal.

The JAX side runs the way its own tests run it on the CPU: the ref path
of ``ops``, and the Pallas page-gather kernel with ``interpret=True``.
The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the parity side; absent where only the port runs

from repro.core.bcq import BCQConfig as JCfg
from repro.core.calibrate import default_universal_codebooks
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.chunked_prefill import chunked_prefill as j_chunked
from repro.kernels.paged_attention import paged_attention as j_paged
from repro.models import layers as jlayers
from repro_torch.core import bcq as tbcq
from repro_torch.kernels import bcq_linear as tlinear
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.chunked_prefill import chunked_prefill as t_chunked
from repro_torch.kernels.paged_attention import paged_attention as t_paged
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import from_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

JC, TC = JCfg(), tbcq.BCQConfig()
CB = default_universal_codebooks(JC).levels
P, PS, HKV, D = 8, 8, 2, 32  # pool shape of tests/test_paged_kernel.py


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed_weight(n, k, seed):
    w = (np.random.default_rng(seed).standard_normal((k, n)) * k**-0.5).astype(np.float32)
    pk = jlayers.pack_weight(jnp.asarray(w), JC, jnp.asarray(CB))
    return w, {n_: np.asarray(v) for n_, v in pk.items()}


def _activation(m, k, seed):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    x[:, :: max(1, k // 8)] *= 12.0  # outlier channels
    return x


# ------------------------------------------------------------ fused linear
@pytest.mark.parametrize("mkn", [(8, 128, 64), (37, 256, 100), (64, 192, 32)])
def test_fused_linear_plain_matches_reference(mkn):
    m, k, n = mkn
    x = _activation(m, k, 1)
    _, pk = _packed_weight(n, k, 2)
    want = np.asarray(
        jops.w4a4_linear_fused(
            jnp.asarray(x), jops.packed_operand({a: jnp.asarray(b) for a, b in pk.items()}),
            jnp.asarray(CB), JC, impl="ref",
        )
    )
    got = tops.w4a4_linear_fused(_t(x), tops.packed_operand(from_numpy_tree(pk)), _t(CB), TC).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    tlinear.BCQ_LINEAR.count = 0
    tlinear.bcq_linear(_t(x), *[_t(a) for a in (pk["idx"], pk["sel"])],
                       tops.packed_operand(from_numpy_tree(pk)).inv_scale, _t(CB),
                       tbcq.tensor_scale(_t(x), TC), TC)
    assert tlinear.BCQ_LINEAR.count == 0  # the CPU branch launches nothing


def test_linear_oracles_match_reference():
    x = _activation(16, 128, 3)
    s_x = np.float32(31.0 / np.abs(x).max())
    qj = jref.quantize_ref(jnp.asarray(x), jnp.asarray(CB), JC, jnp.float32(s_x))
    qt = tref.quantize_ref(_t(x), _t(CB), TC, torch.tensor(s_x))
    for a, b in zip(qt, qj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    inv = np.asarray(jref.inv_scale(qj[2], jnp.float32(s_x)))
    np.testing.assert_array_equal(tref.inv_scale(qt[2], torch.tensor(s_x)).numpy(), inv)
    np.testing.assert_array_equal(
        tref.decode_ref(qt[0], qt[1], _t(inv), _t(CB), TC).numpy(),
        np.asarray(jref.decode_ref(qj[0], qj[1], jnp.asarray(inv), jnp.asarray(CB), JC)),
    )
    # ragged valid_k zeroes the padded arrays' activation scales
    _, pk = _packed_weight(24, 128, 4)
    w_inv = np.asarray(jops.packed_operand({a: jnp.asarray(b) for a, b in pk.items()}).inv_scale)
    want = jref.fused_linear_ref(jnp.asarray(x), jnp.asarray(pk["idx"]), jnp.asarray(pk["sel"]),
                                 jnp.asarray(w_inv), jnp.asarray(CB), JC, jnp.float32(s_x), valid_k=64)
    got = tref.fused_linear_ref(_t(x), _t(pk["idx"]), _t(pk["sel"]), _t(w_inv), _t(CB), TC,
                                torch.tensor(s_x), valid_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


# ------------------------------------------------------------ page gather
def _pool(kind, seed=0):
    """A JAX page pool written from seeded K/V, and its port copy."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, PS, HKV, D)).astype(np.float32)
    v = rng.standard_normal((P, PS, HKV, D)).astype(np.float32)
    jpool = jlayers.cache_write(jlayers.cache_init(P, PS, HKV, D, kind, JC),
                                jnp.asarray(k), jnp.asarray(v), 0, kind, JC, jnp.asarray(CB))
    return jpool, from_numpy_tree({n: np.asarray(a) for n, a in jpool.items()}), (k, v)


@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
def test_port_cache_encode_writes_reference_bytes(kind):
    jpool, tpool, (k, v) = _pool(kind)
    enc = tlayers.cache_encode(_t(k), _t(v), kind, TC, _t(CB), tpool)
    for n, val in enc.items():
        np.testing.assert_array_equal(
            val.float().numpy() if val.dtype == torch.bfloat16 else val.numpy(),
            np.asarray(jpool[n]).astype(np.float32) if kind == "bf16" else np.asarray(jpool[n]),
        )


def _tables(lengths, maxp, seed):
    """Random live pages, NULL (page 0) past each row's live pages."""
    bt = np.random.default_rng(seed).integers(1, P, (len(lengths), maxp)).astype(np.int32)
    for r, n in enumerate(lengths):
        bt[r, -(-n // PS):] = 0
    return bt


@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
@pytest.mark.parametrize("h", [2, 4])  # MHA and 2× GQA
def test_paged_decode_plain_matches_reference(kind, h):
    """Page-boundary lengths, NULL-padded tables and a zero-length row."""
    jpool, tpool, _ = _pool(kind)
    lengths = np.int32([0, 1, PS, PS + 1, 3 * PS, 4 * PS - 1])
    bt = _tables(lengths, 4, 1)
    q = np.random.default_rng(2).standard_normal((len(lengths), h, D)).astype(np.float32)
    cbj = jnp.asarray(CB)
    want = np.asarray(j_paged(jnp.asarray(q), jpool, jnp.asarray(bt), jnp.asarray(lengths), kind,
                              JC, cbj, interpret=True))
    got = t_paged(_t(q), tpool, _t(bt), _t(lengths), kind, TC, _t(CB)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    live = lengths > 0  # the oracle has no defined output for empty rows
    oracle = np.asarray(jref.paged_attention_ref(jnp.asarray(q), jpool, jnp.asarray(bt),
                                                 jnp.asarray(lengths), kind, JC, cbj))
    np.testing.assert_allclose(got[live], oracle[live], atol=2e-5, rtol=2e-5)
    port_oracle = tref.paged_attention_ref(_t(q), tpool, _t(bt), _t(lengths), kind, TC, _t(CB))
    np.testing.assert_allclose(port_oracle.numpy(), oracle, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
@pytest.mark.parametrize("c", [5, 8])  # ragged tail, full-page chunk
def test_chunked_prefill_plain_matches_reference(kind, c):
    """Prefix pages visible to the whole chunk (n_past > 0), causal chunk,
    GQA, NULL padding."""
    jpool, tpool, _ = _pool(kind, seed=3)
    n_past = np.int32([0, PS, 3 * PS - c])
    bt = _tables(n_past + c, 4, 4)
    q = np.random.default_rng(5).standard_normal((3, c, 4, D)).astype(np.float32)
    cbj = jnp.asarray(CB)
    want = np.asarray(j_chunked(jnp.asarray(q), jpool, jnp.asarray(bt), jnp.asarray(n_past), kind,
                                JC, cbj, interpret=True))
    got = t_chunked(_t(q), tpool, _t(bt), _t(n_past), kind, TC, _t(CB)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    oracle = np.asarray(jref.chunked_prefill_ref(jnp.asarray(q), jpool, jnp.asarray(bt),
                                                 jnp.asarray(n_past), kind, JC, cbj))
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=2e-5)
    port_oracle = tref.chunked_prefill_ref(_t(q), tpool, _t(bt), _t(n_past), kind, TC, _t(CB))
    np.testing.assert_allclose(port_oracle.numpy(), oracle, atol=2e-5, rtol=2e-5)


def test_chunk_rows_see_prefix_and_not_future():
    """Corrupting the page slot of chunk token 2 changes rows ≥ 2 only;
    corrupting the last prefix token changes every row."""
    _, tpool, _ = _pool("bf16")
    bt = torch.tensor([[3, 1, 0]], dtype=torch.int32)
    n_past = torch.tensor([PS], dtype=torch.int32)
    q = torch.randn(1, 4, HKV, D, generator=torch.Generator().manual_seed(0))
    base = t_chunked(q, tpool, bt, n_past, "bf16", TC)
    fut = {n: a.clone() for n, a in tpool.items()}
    fut["k"][1, 2:] = 7.0
    out = t_chunked(q, fut, bt, n_past, "bf16", TC)
    assert torch.equal(out[:, :2], base[:, :2]) and not torch.equal(out[:, 2:], base[:, 2:])
    pre = {n: a.clone() for n, a in tpool.items()}
    pre["k"][3, PS - 1] = 9.0
    out = t_chunked(q, pre, bt, n_past, "bf16", TC)
    assert all(not torch.equal(out[:, i], base[:, i]) for i in range(4))
