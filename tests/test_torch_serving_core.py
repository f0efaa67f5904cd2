"""Port parity of the serving core: ``repro_torch`` PagedEngine with prefix
caching, forking with copy-on-write, preemption by eviction, seeded
sampling, EOS and slab admission, against ``repro.serving.PagedEngine``
on the 2-layer smoke gpt3_126m (W4A4 packed weights, bcq4 pool).

Reference settings: ``paged_kernel=False``, ``pipeline_depth=1``.  Both
engines get the same configuration and the same requests (every prompt
drawn from a seeded numpy generator), wave by wave.

Tokens must be equal under the margin rule (``generate.greedy_agreement``)
with ``TOL`` = 1e-3, as tests/test_torch_engine.py: up to the first launch
with a differing token every token is equal, and in that launch a
differing token is accepted only where the port's margin is at most
``TOL`` — for a sampled token the margin is T times the top-1 minus top-2
perturbed score ``logits/T + gumbel``, the logit change that flips it.
The reference records no margins or launches, so its tokens are judged
with the port's.  The engine counters (prefix hits and misses, tokens
skipped, forks, shared pages, copy-on-write copies, preemptions) must be
equal.  Contiguous path: ``prefill``/``decode_step`` logits and
``greedy_generate`` tokens against the reference's.
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
from repro.serving import generate as jgen
from repro.serving.engine import PagedEngine as JEngine
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import generate as tgen
from repro_torch.serving.engine import PagedEngine

CFG, TCFG = get_smoke("gpt3_126m"), t_get_smoke("gpt3_126m")
CB = default_universal_codebooks(JCfg()).as_jnp()
# one slot count, sequence length and chunk for every engine, so that the
# reference's compiled step functions are shared across the tests
PS, CHUNK, SLOTS, MAX_LEN = 8, 16, 4, 32
ENGINE = dict(n_slots=SLOTS, max_len=MAX_LEN, page_size=PS, prefill_chunk=CHUNK)
TOL = 1e-3
STAT_KEYS = ("prefix_hits", "prefix_misses", "prefill_tokens_skipped", "forks", "shared_pages",
             "cow_copies", "preemptions", "prefix_evictions")
SAMPLED = (0.8, 40, 1234)  # temperature, top_k, seed
HOT = (1.0, 0, 7)


@pytest.fixture(scope="module")
def models():
    rt = JRuntime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32)
    packed = jptq.pack_params(jzoo.build(CFG, rt).init(jax.random.PRNGKey(0)), CB, JCfg())
    packed["codebooks"] = CB
    jrt = JRuntime(quant_mode="packed", compute_dtype=jnp.float32, param_dtype=jnp.float32,
                   cache_kind="bcq4", paged_kernel=False, fused_linear=True)
    trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                   paged_kernel=True, fused_linear=True)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, packed))
    return (jzoo.build(CFG, jrt), packed), (tzoo.build(TCFG, trt, device="cpu"), tparams)


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, n).astype(np.int64)


def _request(mod, rid, prompt, max_new, n_samples=1, sampling=None):
    sp = mod.SamplingParams(*sampling) if sampling else mod.GREEDY
    return mod.Request(rid=rid, prompt=prompt, max_new=max_new, n_samples=n_samples, sampling=sp)


def _serve(models, waves, **kw):
    """Run every wave of request specs (rid, prompt, max_new[, n_samples[,
    sampling]]) to completion on both engines.  Returns (reference
    finished, port finished, reference engine, port engine)."""
    (japi, jparams), (tapi, tparams) = models
    jeng = JEngine(japi, jparams, pipeline_depth=1, **kw)
    teng = PagedEngine(tapi, tparams, device="cpu", **kw)
    teng.victims = []  # the rid of every preempted request, in order
    preempt = teng._preempt_one

    def spy(exclude):
        victim = preempt(exclude)
        if victim is not None:
            teng.victims.append(teng.queue[0].rid)
        return victim

    teng._preempt_one = spy
    for wave in waves:
        for spec in wave:
            jeng.submit(_request(jgen, *spec))
            teng.submit(_request(tgen, *spec))
        jeng.run_to_completion()
        teng.run_to_completion()
    return jeng.finished, teng.finished, jeng, teng


def _check(models, waves, **kw):
    """Serve ``waves`` on both engines; assert the margin rule, equal
    counters and clean page accounting.  Returns the port engine and the
    agreement."""
    jfin, tfin, jeng, teng = _serve(models, waves, **kw)
    got = {(r.rid, r.sample_idx): r for r in tfin}
    ref = {}
    for r in jfin:
        g = got.get((r.rid, r.sample_idx))
        lids = [] if g is None else list(g.launch_ids)
        # the reference's extra tokens, if any, sit after every port launch
        lids += [10**9] * (len(r.out) - len(lids))
        ref[(r.rid, r.sample_idx)] = SimpleNamespace(
            out=list(r.out), launch_ids=lids[: len(r.out)],
            margins=(list(g.margins) if g else []) + [0.0] * len(r.out))
    assert len(ref) == len(jfin) and len(got) == len(tfin)
    agree = tgen.greedy_agreement(ref, got, TOL)
    assert agree["ok"], (agree, {k: r.out for k, r in ref.items()},
                         {k: r.out for k, r in got.items()})
    assert agree["equal_tokens"] > 0
    if agree["first_diff_launch"] is None:
        assert {k: r.out for k, r in ref.items()} == {k: r.out for k, r in got.items()}
        assert {k: jeng.stats[k] for k in STAT_KEYS} == {k: teng.stats[k] for k in STAT_KEYS}
    assert {(r.rid, r.error is None) for r in jfin} == {(r.rid, r.error is None) for r in tfin}
    _assert_clean(teng)
    return teng, agree


def _assert_clean(eng):
    """After the drain: no reference held, every page free or parked, the
    parked pages exactly the registered ones."""
    assert (eng.pool_mgr.refcount == 0).all()
    assert all(s.req is None and s.reserved_by is None for s in eng.slots)
    free, parked = set(eng.pool_mgr.free), set(eng.prefix.reclaimable)
    assert not free & parked
    assert free | parked == set(range(1, eng.pool_mgr.n_pages))
    assert parked == set(eng.prefix.hash_of)


# ------------------------------------------------------------- scenarios
def test_prefix_sharing_over_two_waves(models):
    """Wave 1 registers a shared 2-page prefix as its chunks complete; wave
    2 revives the parked pages and prefills only the suffixes.  (Prompt
    lengths keep every chunk in one shape bucket: each new shape costs the
    reference a compilation of seconds.)"""
    shared = _tokens(2 * PS, 1)
    wave = lambda base: [(base + i, np.concatenate([shared, _tokens(n, base + i)]), 4)
                         for i, n in enumerate((9, 10, 11))]
    eng, _ = _check(models, [wave(0), wave(10)], chunked_prefill=True, **ENGINE)
    assert eng.stats["prefix_hits"] == 6 and eng.stats["prefill_tokens_skipped"] == 48


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "slab"])
def test_forking_greedy_and_sampled(models, chunked):
    """n_samples 3 greedy (every sibling the same stream) and sampled, beside
    a plain request and a hot sampled one; the shared tail pages are copied
    on first write."""
    waves = [[(0, _tokens(21, 2), 6, 3), (1, _tokens(21, 3), 6, 3, SAMPLED),
              (2, _tokens(21, 4), 5), (3, _tokens(21, 5), 5, 1, HOT)]]
    eng, _ = _check(models, waves, chunked_prefill=chunked, **ENGINE)
    assert eng.stats["forks"] == 2 and eng.stats["cow_copies"] >= 4
    outs = {r.sample_idx: r.out for r in eng.finished if r.rid == 0}
    assert len(outs) == 3 and outs[0] == outs[1] == outs[2]


def test_forced_preemption_once_and_twice(models):
    """A pool of 4 pages for three sequences that need 3 each preempts the
    youngest, which recomputes as prompt + output: request 2 is preempted
    once, request 1 (sampled) twice — its second requeue appends only the
    output generated since the first."""
    waves = [[(0, _tokens(9, 6), 14), (1, _tokens(7, 7), 14, 1, SAMPLED),
              (2, _tokens(5, 8), 14)]]
    eng, _ = _check(models, waves, n_pages=5, watermark=1, prefix_caching=False,
                    chunked_prefill=True, **ENGINE)
    assert sorted(eng.victims) == [1, 1, 2]
    for r in eng.finished:  # the folded prompt is the original + a prefix of out
        if r._orig_plen is not None:
            assert list(r.prompt[r._orig_plen:]) == r.out[: len(r.prompt) - r._orig_plen]


def test_eos_stops_a_request(models):
    """eos_id set to a token one greedy request emits at its fourth
    position: it stops there, on both engines."""
    waves = [[(0, _tokens(11, 9), 8), (1, _tokens(25, 10), 5)]]
    kw = dict(chunked_prefill=True, **ENGINE)
    base, _, _, _ = _serve(models, waves, **kw)
    eos = next(r for r in base if r.rid == 0).out[3]
    eng, _ = _check(models, waves, eos_id=int(eos), **kw)
    out = next(r for r in eng.finished if r.rid == 0).out
    assert out[-1] == eos and eos not in out[:-1] and len(out) <= 4


def test_slab_admission_with_prefix_hits(models):
    """Non-chunked admission: the whole prompt in one slab prefill, only the
    missed pages scattered into the pool; the second prompt hits the
    first's pages."""
    shared = _tokens(2 * PS, 11)
    waves = [[(0, np.concatenate([shared, _tokens(5, 12)]), 5)],
             [(1, np.concatenate([shared, _tokens(5, 13)]), 5), (2, _tokens(21, 14), 4)]]
    eng, _ = _check(models, waves, **ENGINE)
    assert eng.stats["prefix_hits"] == 2 and eng.stats["prefill_launches"] == 3


def test_submit_rejections(models):
    """n_samples outside [1, n_slots] and a slab prompt of max_len tokens
    finish at once with a typed error, and the rest is served."""
    waves = [[(0, _tokens(6, 15), 3, SLOTS + 1), (1, _tokens(MAX_LEN, 16), 3),
              (2, _tokens(21, 17), 3)]]
    jfin, tfin, _, teng = _serve(models, waves, **ENGINE)
    kinds = lambda fin: {r.rid: getattr(r.error, "kind", None) for r in fin}
    assert kinds(tfin) == kinds(jfin) == {0: "invalid", 1: "too_long", 2: None}
    assert [r.out for r in tfin if r.rid == 2] == [list(r.out) for r in jfin if r.rid == 2]


@pytest.mark.parametrize("chunked", [False, True], ids=["slab", "chunked"])
def test_refused_admission_is_side_effect_free(models, chunked):
    """A refused admission leaves the prefix LRU, the counters, the
    refcounts, the free list and the tables as they were, and the parked
    pages stay claimable."""
    _, (tapi, tparams) = models
    a, b = _tokens(2 * PS, 18), _tokens(2 * PS, 19)
    eng = PagedEngine(tapi, tparams, n_slots=2, max_len=32, page_size=PS, n_pages=10,
                      chunked_prefill=chunked, prefill_chunk=PS, device="cpu")
    for rid, p in enumerate((a, b)):
        eng.submit(tgen.Request(rid=rid, prompt=np.concatenate([p, p[:3]]), max_new=2))
        eng.run_to_completion()
    assert eng.prefix.reclaimable_count() == 4
    before = (list(eng.prefix.reclaimable), dict(eng.stats), eng.pool_mgr.refcount.copy(),
              list(eng.pool_mgr.free), eng.tables.copy())
    eng.watermark = 10
    big = tgen.Request(rid=9, prompt=np.concatenate([a, a[:5]]), max_new=2)
    for _ in range(3):
        assert not eng._try_admit(big, 0)
    after = (list(eng.prefix.reclaimable), dict(eng.stats), eng.pool_mgr.refcount.copy(),
             list(eng.pool_mgr.free), eng.tables.copy())
    assert before[:2] == after[:2] and before[3] == after[3]
    np.testing.assert_array_equal(before[2], after[2])
    np.testing.assert_array_equal(before[4], after[4])
    assert all(s.req is None for s in eng.slots)
    eng.watermark = 1
    assert eng._try_admit(big, 0)
    assert eng.stats["prefix_hits"] == before[1]["prefix_hits"] + 2


# -------------------------------------------------------- contiguous path
def test_prefill_and_decode_step_logits(models):
    """``prefill`` over a max_len slab and two ``decode_step``s: logits
    within 1e-3 of the reference's, caches' bcq4 bytes equal up to
    codebook ties in decoded values."""
    (japi, jparams), (tapi, tparams) = models
    prompts = np.stack([_tokens(11, 20), _tokens(11, 21)]).astype(np.int32)
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(prompts)}, 32)
    tl, tc = tapi.prefill_fn(tparams, {"tokens": torch.from_numpy(prompts)}, 32)
    logits = [(np.asarray(jl), tl.numpy())]
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for pos in (11, 12):
        jl, jc = japi.decode_fn(jparams, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = tapi.decode_fn(tparams, tc, torch.from_numpy(tok), pos)
        logits.append((np.asarray(jl), tl.numpy()))
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for a, b in logits:
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=TOL, rtol=0)
    for n in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))


def test_greedy_generate_matches_reference(models):
    (japi, jparams), (tapi, tparams) = models
    prompts = np.stack([_tokens(9, 22), _tokens(9, 23)]).astype(np.int32)
    ref = np.asarray(jgen.greedy_generate(japi, jparams, jnp.asarray(prompts), 6, 32))
    got = tgen.greedy_generate(tapi, tparams, prompts, 6, 32, device="cpu").numpy()
    assert got.shape == ref.shape == (2, 6)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------- prefix, pages
def test_chain_digests_match_reference():
    from repro.serving import prefix as jprefix
    from repro_torch.serving import prefix as tprefix

    for seed, n in ((30, 40), (31, 17), (32, 8)):
        prompt = _tokens(n, seed)
        assert tprefix.chunk_hashes(prompt, PS) == jprefix.chunk_hashes(prompt, PS)
        assert tprefix.chain_hash(b"\x01" * 16, prompt[:5]) == jprefix.chain_hash(
            b"\x01" * 16, prompt[:5])
    assert tprefix.chunk_hashes(np.arange(7), PS) == []


def test_prefix_cache_lru_and_revive_match_reference():
    """The same register / park / lookup / evict sequence on both caches and
    page pools gives the same LRU order, evictions and refcounts."""
    from repro.serving import pages as jpages
    from repro.serving import prefix as jprefix
    from repro_torch.serving import pages as tpages
    from repro_torch.serving import prefix as tprefix

    hashes = tprefix.chunk_hashes(_tokens(6 * PS, 33), PS)
    sides = []
    for pages, prefix in ((jpages, jprefix), (tpages, tprefix)):
        pool, cache, log = pages.PagePool(8), prefix.PrefixCache(), []
        pids = [pool.alloc() for _ in hashes]
        for h, pid in zip(hashes, pids):
            cache.register(h, pid)
        cache.register(hashes[0], pool.alloc())  # a racing copy stays private
        for pid in (pids[2], pids[0], pids[4], pids[1]):
            assert pool.deref(pid)
            cache.mark_reclaimable(pid)
        log.append(list(cache.reclaimable))
        got = cache.lookup(hashes[0])  # revive the second-oldest
        pool.revive(got)
        log += [got, list(cache.reclaimable), cache.pop_lru(), cache.pop_lru(),
                cache.reclaimable_count(), cache.peek(hashes[2]), cache.knows(pids[4]),
                pool.refcount.tolist()]
        sides.append(log)
    assert sides[0] == sides[1]


def _pool_pair(kind, n_pages=6, seed=34):
    """The same random stacked pool (2 layers, page 8, 2 heads of 32) as a
    reference tree and a port tree."""
    from repro.models.layers import cache_init as jcache_init

    rng = np.random.default_rng(seed)
    one = jcache_init(n_pages, PS, 2, 32, kind, JCfg())
    tree = {}
    for n, leaf in one.items():
        shape = (2,) + leaf.shape
        if leaf.ndim < 2:
            tree[n] = np.ones(shape, np.float32)
        elif leaf.dtype == jnp.bfloat16:
            tree[n] = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
        elif leaf.dtype == jnp.float32:
            tree[n] = rng.random(shape).astype(np.float32)
        else:
            tree[n] = rng.integers(-128 if leaf.dtype == jnp.int8 else 0,
                                   128 if leaf.dtype == jnp.int8 else 256,
                                   shape).astype(np.asarray(leaf).dtype)
    return {n: jnp.asarray(a) for n, a in tree.items()}, from_numpy_tree(tree)


def _same_bytes(jtree, ttree):
    for n, leaf in jtree.items():
        a = np.asarray(leaf)
        b = ttree[n].float().numpy() if ttree[n].dtype == torch.bfloat16 else ttree[n].numpy()
        np.testing.assert_array_equal(b, a.astype(np.float32) if a.dtype.name == "bfloat16" else a)


@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
def test_copy_page_and_scatter_bytes_match_reference(kind):
    from repro.serving import pages as jpages
    from repro_torch.serving import pages as tpages

    jpool, tpool = _pool_pair(kind)
    jpool = jpages.copy_page(jpool, 3, 5)
    tpages.copy_page(tpool, 3, 5)
    _same_bytes(jpool, tpool)
    # a 4-page prefill cache into pages 2 and 4; the NULL entries (a hit
    # and the padding) all land in the null page, last chunk wins
    jc, tc = ({n: (a if a.ndim < 3 else a.reshape((2, 1, 4 * PS) + tuple(a.shape[3:])))
               for n, a in tree.items()} for tree in _pool_pair(kind, n_pages=4, seed=35))
    ids = np.array([0, 2, 4, 0], np.int32)
    jpool = jpages.scatter_prefill_pages(jpool, jc, jnp.asarray(ids))
    tpages.scatter_prefill_pages(tpool, tc, torch.from_numpy(ids))
    _same_bytes(jpool, tpool)
