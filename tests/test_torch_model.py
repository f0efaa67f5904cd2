"""Port parity: the 2-layer smoke gpt3_126m against the JAX package.

Both packages run the same weights (the reference's tree, moved across
with ``models.convert``), W4A4 packed linears and a paged KV pool, on the
same launches: a padded chunked-prefill batch (a zero pad row, padded
chunk columns, per-row ``chunk_len``) and then a decode launch whose idle
rows sit at length 0 on the null page with DIFFERENT stale tokens — the
duplicate-scatter case that must resolve last row wins.

Tolerance for logits: ``atol = 1e-4 · max|logits|``, ``rtol = 1e-4``.
The encodes and decodes are bit-identical (tests/test_torch_numerics.py);
what differs is the f32 summation order of the matmuls, norms and
softmax (torch vs XLA on the CPU), compounded over two layers.  Pool
bytes may differ only where that rounding crosses a quantization
boundary: at most 1 element in 1000 per quantized leaf.  The idle rows' logits
read back the null-page token, so a wrong duplicate winner fails them.
"""
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
from repro.models import zoo as jzoo
from repro.models.layers import Runtime as JRuntime
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.core import ptq as tptq
from repro_torch.core.bcq import BCQConfig as TCfg
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.models.layers import _last_writer

CFG, TCFG = get_smoke("gpt3_126m"), t_get_smoke("gpt3_126m")
CB = default_universal_codebooks(JCfg()).as_jnp()
PS, N_PAGES = 8, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    rt = JRuntime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32)
    params = jzoo.build(CFG, rt).init(jax.random.PRNGKey(0))
    packed = jptq.pack_params(params, CB, JCfg())
    packed["codebooks"] = CB
    return params, packed


def test_pack_params_bytes_match_reference(weights):
    params, packed = weights
    ours = tptq.pack_params(from_numpy_tree(_np(params)), torch.from_numpy(np.array(CB)), TCfg())
    flat = jax.tree_util.tree_flatten_with_path({k: v for k, v in packed.items() if k != "codebooks"})[0]
    for path, leaf in flat:
        node = ours
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf), err_msg=jax.tree_util.keystr(path))


def _apis(kind, paged_kernel, fused):
    jrt = JRuntime(quant_mode="packed", compute_dtype=jnp.float32, param_dtype=jnp.float32,
                   cache_kind=kind, paged_kernel=False, fused_linear=fused)
    trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind=kind,
                   paged_kernel=paged_kernel, fused_linear=fused)
    return jzoo.build(CFG, jrt), tzoo.build(TCFG, trt, device="cpu")


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _same_pool(tpool, jpool):
    """Quantized page leaves agree except where a K/V value lies within f32
    rounding of a quantization boundary (bf16 or int8 rounding, a BCQ
    threshold): at most 1 in 1000 elements per leaf.  f32 leaves (int8
    scales, the pool-global s_x) agree to f32 rounding."""
    for n, leaf in jpool.items():
        a = tpool[n]
        want = np.asarray(leaf)
        if a.dtype == torch.float32:
            np.testing.assert_allclose(a.numpy(), want, rtol=1e-5, err_msg=n)
            continue
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        diff = np.mean(a != want.astype(a.dtype))
        assert diff <= 1e-3, (n, diff)


@pytest.mark.parametrize(
    "kind,paged_kernel,fused",
    [("bcq4", True, True), ("bcq4", False, False), ("int8", True, True), ("bf16", False, True)],
)
def test_prefill_then_decode_logits_match_reference(weights, kind, paged_kernel, fused):
    _, packed = weights
    japi, tapi = _apis(kind, paged_kernel, fused)
    tparams = from_numpy_tree(_np(packed))
    jpool, tpool = japi.pool_init(N_PAGES, PS), tapi.pool_init(N_PAGES, PS)
    rng = np.random.default_rng(0)

    # prefill: 2 real rows (11 and 16 tokens) + 1 zero pad row, chunk bucket 16
    tokens = np.zeros((4, 16), np.int32)
    tokens[0, :11] = rng.integers(0, CFG.vocab, 11)
    tokens[1] = rng.integers(0, CFG.vocab, 16)
    tokens[2] = rng.integers(0, CFG.vocab, 16)
    tables = np.zeros((4, 4), np.int32)
    tables[0, :2], tables[1, :2], tables[2, :2] = [1, 2], [3, 4], [5, 6]
    ids = tables[:, :2].copy()
    n_past = np.zeros(4, np.int32)
    clen = np.int32([11, 16, 16, 0])
    jl, jpool = japi.prefill_from_pages_fn(
        packed, jnp.asarray(tokens), jpool, jnp.asarray(tables), jnp.asarray(n_past),
        jnp.asarray(ids), jnp.asarray(clen))
    tl, tpool = tapi.prefill_from_pages_fn(
        tparams, torch.from_numpy(tokens), tpool, torch.from_numpy(tables),
        torch.from_numpy(n_past), torch.from_numpy(ids), chunk_len=torch.from_numpy(clen))
    _close(tl, jl)
    _same_pool(tpool, jpool)

    # decode: rows 0 and 2 live; rows 1 and 3 idle (length 0, NULL table)
    # with different stale tokens — both write null-page slot 0
    dec_tok = np.int32([[5], [77], [9], [300]])
    lengths = np.int32([11, 0, 16, 0])
    dtab = np.zeros((4, 4), np.int32)
    dtab[0], dtab[2] = tables[0], [5, 6, 7, 0]
    for _ in range(2):
        jl, jpool = japi.paged_decode_fn(packed, jpool, jnp.asarray(dec_tok), jnp.asarray(dtab),
                                         jnp.asarray(lengths))
        tl, tpool = tapi.paged_decode_fn(tparams, tpool, torch.from_numpy(dec_tok),
                                         torch.from_numpy(dtab), torch.from_numpy(lengths))
        _close(tl, jl)
        _same_pool(tpool, jpool)
        dec_tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        lengths = lengths + np.int32([1, 0, 1, 0])


def test_last_writer_resolves_duplicates_to_the_last_row():
    ids = torch.tensor([0, 5, 0, 7, 0, 5])
    assert _last_writer(ids).tolist() == [4, 5, 4, 3, 4, 5]
