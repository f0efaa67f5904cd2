"""Port parity: greedy serving of ``repro_torch`` PagedEngine against
``repro.serving.PagedEngine`` on the 2-layer smoke gpt3_126m (W4A4 packed
weights, bcq4 pool).

Reference settings: ``chunked_prefill=True``, ``prefix_caching=False``,
``pipeline_depth=1``, ``paged_kernel=False``; both engines get the same
``n_slots`` and the same requests.  (The serving-core features — prefix
caching, forking, preemption, sampling, EOS, slab admission — are held
to the reference in tests/test_torch_serving_core.py.)  The request mix has one prompt
shorter than a page, one longer than a chunk, and different budgets, so
slots go idle at different ticks and ride later decode launches at
length 0 on the null page with different stale tokens.

Tokens must be equal under the margin rule (``generate.greedy_agreement``):
a differing token is accepted only where the port's top-1 minus top-2
logit margin is at most ``TOL`` = 1e-3, about ten times the largest
logit difference the model tests see between the packages
(tests/test_torch_model.py).
"""
from types import SimpleNamespace

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
from repro.serving.engine import PagedEngine as JEngine
from repro.serving.generate import Request as JRequest
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving.engine import PagedEngine, PagePoolExhaustedError, _pow2_bucket
from repro_torch.serving.generate import Request, greedy_agreement

CFG, TCFG = get_smoke("gpt3_126m"), t_get_smoke("gpt3_126m")
CB = default_universal_codebooks(JCfg()).as_jnp()
PS, CHUNK, MAX_LEN, N_SLOTS = 8, 16, 64, 4
PLENS = (5, 37, 12, 20)  # < one page, > one chunk, two in between
BUDGETS = (2, 8, 5, 3)  # slots go idle at different ticks
TOL = 1e-3


def _packed_params():
    rt = JRuntime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32)
    packed = jptq.pack_params(jzoo.build(CFG, rt).init(jax.random.PRNGKey(0)), CB, JCfg())
    packed["codebooks"] = CB
    return packed


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab, n) for n in PLENS]


@pytest.fixture(scope="module")
def reference():
    packed = _packed_params()
    rt = JRuntime(quant_mode="packed", compute_dtype=jnp.float32, param_dtype=jnp.float32,
                  cache_kind="bcq4", paged_kernel=False, fused_linear=True)
    eng = JEngine(jzoo.build(CFG, rt), packed, n_slots=N_SLOTS, max_len=MAX_LEN, page_size=PS,
                  chunked_prefill=True, prefill_chunk=CHUNK, prefix_caching=False,
                  pipeline_depth=1)
    for i, (p, n) in enumerate(zip(_prompts(), BUDGETS)):
        eng.submit(JRequest(rid=i, prompt=p, max_new=n))
    finished, ticks = eng.run_to_completion()
    return packed, {r.rid: list(r.out) for r in finished}, ticks


def _port_run(packed, kernels: bool):
    rt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                  paged_kernel=kernels, fused_linear=kernels)
    api = tzoo.build(TCFG, rt, device="cpu")
    params = from_numpy_tree(jax.tree.map(np.asarray, packed))
    eng = PagedEngine(api, params, n_slots=N_SLOTS, max_len=MAX_LEN, page_size=PS,
                      prefill_chunk=CHUNK, chunked_prefill=True, prefix_caching=False,
                      device="cpu")
    for i, (p, n) in enumerate(zip(_prompts(), BUDGETS)):
        eng.submit(Request(rid=i, prompt=p, max_new=n))
    finished, ticks = eng.run_to_completion()
    return {r.rid: r for r in finished}, ticks, eng


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel-paths", "plain-paths"])
def test_greedy_tokens_match_reference_engine(reference, kernels):
    packed, ref, ref_ticks = reference
    got, ticks, eng = _port_run(packed, kernels)
    assert ticks == ref_ticks
    assert {r: len(q.out) for r, q in got.items()} == {r: n + 1 for r, n in enumerate(BUDGETS)}
    # the reference records no margins: both engines run the same schedule,
    # so its tokens are judged with the port's margins and launch ids
    ref_reqs = {r: SimpleNamespace(out=t, margins=got[r].margins, launch_ids=got[r].launch_ids)
                for r, t in ref.items()}
    agree = greedy_agreement(ref_reqs, got, TOL)
    assert agree["ok"], (agree, ref, {r: q.out for r, q in got.items()})
    assert eng.pool_mgr.used() == 0  # every page returned
    assert eng.stats["prefill_tokens"] == sum(PLENS)


def _tiny_engine(n_pages=None, max_len=32, **kw):
    rt = TRuntime(quant_mode="none", compute_dtype=torch.float32, cache_kind="bf16")
    api = tzoo.build(TCFG, rt, device="cpu")
    return PagedEngine(api, api.init(0), n_slots=2, max_len=max_len, page_size=PS,
                       n_pages=n_pages, prefill_chunk=CHUNK, chunked_prefill=True,
                       device="cpu", **kw)


def test_pool_that_cannot_admit_raises():
    # shed_stuck=False: the fail-stop of capacity planning (the default
    # sheds the request instead, tests/test_torch_faults.py)
    eng = _tiny_engine(n_pages=3, shed_stuck=False)  # 2 usable pages < prompt pages + watermark
    eng.submit(Request(rid=0, prompt=np.arange(20), max_new=2))
    with pytest.raises(PagePoolExhaustedError):
        eng.run_to_completion()


def test_pool_dry_mid_decode_raises_instead_of_preempting():
    """A lone sequence that outgrows the pool has no one else to preempt:
    it preempts itself, its recomputed prompt no longer fits above the
    watermark, and the engine raises."""
    eng = _tiny_engine(n_pages=5, shed_stuck=False)  # admits a 1-page prompt, runs dry decoding
    eng.submit(Request(rid=0, prompt=np.arange(3), max_new=40))
    with pytest.raises(PagePoolExhaustedError):
        eng.run_to_completion()
    assert eng.stats["preemptions"] >= 1


def test_sampling_is_refused():
    """A sampled request is served now; what submit refuses is a request
    it cannot serve, and it finishes it with a typed error instead of
    raising."""
    from repro_torch.serving.generate import SamplingParams

    eng = _tiny_engine()
    bad = Request(rid=0, prompt=np.arange(3), max_new=2, n_samples=3,
                  sampling=SamplingParams(temperature=0.7))
    eng.submit(bad)
    assert bad.done and bad.error.kind == "invalid" and not eng.queue
    eng.submit(Request(rid=1, prompt=np.arange(3), max_new=2,
                       sampling=SamplingParams(temperature=0.7)))
    finished, _ = eng.run_to_completion()
    assert [len(r.out) for r in finished if r.rid == 1] == [3]


def test_pow2_buckets():
    assert [_pow2_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]
