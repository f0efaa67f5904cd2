"""The port's production decode tick: the depth-2 pipelined ``PagedEngine``
over the fused decode step (one CUDA graph per bucket on the card).

On the CPU the port at ``pipeline_depth=2`` is held to itself at depth 1
and under ``profile_sync`` BIT FOR BIT — tokens, margins, launch indices,
every engine counter and the final pool bytes — across bf16 / int8 / bcq4
pages, greedy and sampled requests, chunked and slab admission, a forked
sampled request and a pool small enough to preempt; and to
``repro.serving.PagedEngine(pipeline_depth=2)`` under the margin rule
(``TOL`` 1e-3, as tests/test_torch_serving_core.py) with equal counters.
The model is the 2-layer smoke gpt3_126m with W4A4 packed weights, the
reference at ``paged_kernel=False``.

Why the port frees a slot early: the W4A4 activation scale of every
linear is one reduction over the whole launch, idle rows included, so a
launch's tokens depend on which requests share it and on the idle rows'
tokens.  The reference keeps a slot whose last token is in flight
occupied until the sync, which delays the next admission by a tick at
depth 2; the port frees it where depth 1 does.  The reference comparison
therefore uses workloads in which no admission waits for a slot (the
reference's own depth 2 equals its depth 1 there).

The ``cuda``-marked tests hold the graph to the eager step on the card
and count captures and launches; they skip without a card.  They need
no JAX: the reference side is imported by the ``ref`` fixture only.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch as t_get_arch
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.core import ptq as tptq
from repro_torch.kernels import build, ops
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import generate as tgen
from repro_torch.serving.engine import ENGINE_STAT_KEYS, PagedEngine, fused_decode
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

TCFG = t_get_smoke("gpt3_126m")
PS, CHUNK, SLOTS, MAX_LEN = 8, 16, 4, 32  # tests/test_torch_serving_core.py's engine
ENGINE = dict(n_slots=SLOTS, max_len=MAX_LEN, page_size=PS, prefill_chunk=CHUNK)
TOL = 1e-3
COUNTERS = tuple(k for k in ENGINE_STAT_KEYS if not k.startswith("t_"))  # all but times
SAMPLED = (0.8, 40, 1234)  # temperature, top_k, seed
HOT = (1.0, 0, 7)
# (prompt length, max_new): six requests on four slots, retiring at
# different ticks, so that admissions wait for freed slots
WORKLOAD = ((5, 6), (9, 3), (7, 8), (12, 4), (3, 5), (10, 6))


@pytest.fixture(scope="module")
def ref():
    """The reference package (the parity side; absent where only the port
    runs, and then the tests that take it skip)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import get_smoke
    from repro.core import ptq
    from repro.core.bcq import BCQConfig
    from repro.core.calibrate import default_universal_codebooks
    from repro.models import zoo
    from repro.models.layers import Runtime
    from repro.serving import generate
    from repro.serving.engine import PagedEngine as Engine

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=get_smoke("gpt3_126m"), ptq=ptq,
                           bcq_cfg=BCQConfig(), zoo=zoo, Runtime=Runtime, gen=generate,
                           Engine=Engine,
                           cb=default_universal_codebooks(BCQConfig()).as_jnp())


@pytest.fixture(scope="module")
def packed(ref):
    """The reference's packed smoke tree (seeded ``jax.random`` weights)."""
    rt = ref.Runtime(quant_mode="none", compute_dtype=ref.jnp.float32,
                     param_dtype=ref.jnp.float32)
    params = ref.zoo.build(ref.cfg, rt).init(ref.jax.random.PRNGKey(0))
    tree = ref.ptq.pack_params(params, ref.cb, ref.bcq_cfg)
    tree["codebooks"] = ref.cb
    return ref.jax.tree.map(np.asarray, tree)


def _port(packed, kind="bcq4"):
    trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind=kind,
                   paged_kernel=True, fused_linear=True)
    return tzoo.build(TCFG, trt, device="cpu"), from_numpy_tree(packed)


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, TCFG.vocab, n).astype(np.int64)


def _specs(sampled=False, workload=WORKLOAD):
    """(rid, prompt, max_new, n_samples, sampling) of each request; with
    ``sampled`` every odd request samples (one of them over the whole
    vocabulary at T 1.0)."""
    out = []
    for rid, (n, max_new) in enumerate(workload):
        sp = None
        if sampled and rid % 2:
            sp = HOT if rid == 3 else SAMPLED
        out.append((rid, _tokens(n, rid), max_new, 1, sp))
    return out


def _request(mod, rid, prompt, max_new, n_samples=1, sampling=None):
    sp = mod.SamplingParams(*sampling) if sampling else mod.GREEDY
    return mod.Request(rid=rid, prompt=prompt, max_new=max_new, n_samples=n_samples, sampling=sp)


def _run(api, params, specs, setup=None, **kw):
    """Serve ``specs`` on a port engine (CPU; ``setup`` called on it first)
    to completion.  Returns (key → (tokens, margins, launch indices),
    counters, pool bytes, engine)."""
    eng = PagedEngine(api, params, device="cpu", **{**ENGINE, **kw})
    if setup is not None:
        setup(eng)
    for spec in specs:
        eng.submit(_request(tgen, *spec))
    eng.run_to_completion()
    assert not eng._inflight and not eng._retiring
    assert all(r.error is None for r in eng.finished)
    out = {(r.rid, r.sample_idx): (list(r.out), list(r.margins), list(r.launch_ids))
           for r in eng.finished}
    stats = {k: eng.stats[k] for k in COUNTERS}
    pool = {n: t.clone() for n, t in eng.pool.items()}
    return out, stats, pool, eng


def _assert_same(a, b):
    assert a[0] == b[0]  # tokens, margins and launch indices, bit for bit
    assert a[1] == b[1]
    assert a[2].keys() == b[2].keys()
    for n in a[2]:
        assert torch.equal(a[2][n], b[2][n]), n


def _depths(api, params, specs, **kw):
    """The port at depth 1, at depth 2 and under profile_sync (depth 2
    asked for): all bit-equal.  Returns the depth-2 run."""
    runs = [_run(api, params, specs, pipeline_depth=d, profile_sync=p, **kw)
            for d, p in ((1, False), (2, False), (2, True))]
    assert runs[2][3].pipeline_depth == 1
    _assert_same(runs[0], runs[1])
    _assert_same(runs[0], runs[2])
    return runs[1]


# --------------------------------------------- depth 2 ≡ depth 1 ≡ profile_sync
@pytest.mark.parametrize("chunked", (True, False), ids=("chunked", "slab"))
@pytest.mark.parametrize("sampled", (False, True), ids=("greedy", "sampled"))
@pytest.mark.parametrize("kind", ("bf16", "int8", "bcq4"))
def test_depth2_equals_depth1_bit_for_bit(packed, kind, sampled, chunked):
    api, params = _port(packed, kind)
    out, stats, _, _ = _depths(api, params, _specs(sampled), chunked_prefill=chunked)
    assert len(out) == len(WORKLOAD) and stats["decode_ticks"] > 0


@pytest.mark.parametrize("case", ("fork", "preempt"))
def test_depth2_equals_depth1_fork_and_preemption(packed, case):
    """A sampled request forked in 3 (copy-on-write tail pages) beside
    greedy ones; a pool small enough that the engine preempts (drained
    first at depth 2)."""
    api, params = _port(packed)
    if case == "fork":
        specs = [(0, _tokens(11, 0), 6, 3, SAMPLED), (1, _tokens(6, 1), 5, 1, None),
                 (2, _tokens(9, 2), 4, 1, None)]
        out, stats, _, _ = _depths(api, params, specs, chunked_prefill=True)
        assert stats["forks"] == 1 and stats["cow_copies"] > 0 and len(out) == 5
    else:
        specs = [(rid, _tokens(n, 10 + rid), 8, 1, SAMPLED if rid == 2 else None)
                 for rid, n in enumerate((9, 13, 6, 11))]
        _, stats, _, _ = _depths(api, params, specs, chunked_prefill=True, n_slots=3,
                                 n_pages=8, max_len=48)
        assert stats["preemptions"] > 0


# ------------------------------------------- depth 2 against the reference's
@pytest.mark.parametrize("chunked,sampled", ((True, False), (True, True), (False, False)),
                         ids=("chunked-greedy", "chunked-sampled", "slab-greedy"))
def test_depth2_matches_reference_depth2(ref, packed, chunked, sampled):
    """Port at depth 2 against the reference at depth 2: tokens under the
    margin rule, counters equal.  Four requests of one prompt length and
    budget start decoding together and retire together, so no admission
    waits for a slot.  (Slab admission with sampled rows is left out: on
    this workload the last decode launch's logits differ by 0.07–0.09 in
    every row at depth 1 as well, a W4A4 activation-scale flip between the
    two packages' roundings; ROADMAP C.)"""
    jrt = ref.Runtime(quant_mode="packed", compute_dtype=ref.jnp.float32,
                      param_dtype=ref.jnp.float32, cache_kind="bcq4", paged_kernel=False,
                      fused_linear=True)
    jtree = ref.jax.tree.map(ref.jnp.asarray, packed)
    jeng = ref.Engine(ref.zoo.build(ref.cfg, jrt), jtree, pipeline_depth=2,
                      chunked_prefill=chunked, **ENGINE)
    specs = _specs(sampled, workload=((9, 6),) * SLOTS)
    for spec in specs:
        jeng.submit(_request(ref.gen, *spec))
    jeng.run_to_completion()
    api, params = _port(packed)
    out, stats, _, teng = _run(api, params, specs, pipeline_depth=2, chunked_prefill=chunked)
    got = {(r.rid, r.sample_idx): r for r in teng.finished}
    # the reference records no margins or launches: its tokens are judged
    # with the port's
    want = {(r.rid, r.sample_idx): SimpleNamespace(
        out=list(r.out), launch_ids=out[(r.rid, r.sample_idx)][2],
        margins=out[(r.rid, r.sample_idx)][1]) for r in jeng.finished}
    agree = tgen.greedy_agreement(want, got, TOL)
    assert agree["ok"] and agree["equal_tokens"] > 0, agree
    assert {k: jeng.stats[k] for k in COUNTERS} == stats


# ------------------------------------------------------------ pipeline surface
def test_manual_step_then_drain(packed):
    """Manual step() calls on a depth-2 engine leave at most one launch in
    flight; after drain() every launched token is booked, and the outputs
    equal a depth-1 run's."""
    api, params = _port(packed)
    specs = _specs()
    eng = PagedEngine(api, params, device="cpu", pipeline_depth=2, chunked_prefill=True,
                      **ENGINE)
    for spec in specs:
        eng.submit(_request(tgen, *spec))
    while eng.queue or eng._active():
        eng.step()
        assert len(eng._inflight) <= 1
    assert eng._inflight  # the last launch is still to be booked
    eng.drain()
    assert not eng._inflight and not eng._retiring
    got = {(r.rid, r.sample_idx): (r.out, r.margins, r.launch_ids) for r in eng.finished}
    assert got == _run(api, params, specs, chunked_prefill=True)[0]
    assert eng.trace_counts() == {"prefill": 0, "decode": 0, "chunk": 0}  # eager on the CPU


def test_speculative_eos_row_is_discarded(packed):
    """With ``eos_id`` set, a row launched after its request's EOS (depth
    2 learns of the EOS one launch late) is dropped at sync: the request
    ends at its EOS as at depth 1, no request runs past an EOS or past
    ``max_new``, and depth 2 launched rows that booked nothing.  (Only the
    EOS is speculative: from the launch after it the two depths' batches,
    and so their W4A4 activation scales, may differ.)"""
    api, params = _port(packed)
    base = _run(api, params, _specs(), chunked_prefill=True)[0]
    # EOS: request 2's first decode token that it has not emitted before
    toks2 = base[(2, 0)][0]
    at = next(p for p in range(2, len(toks2) - 1) if toks2[p] not in toks2[:p])
    eos = int(toks2[at])
    runs, launched = [], []
    for depth in (1, 2):
        rows = []

        def spy(eng, rows=rows):
            real = eng._launch_decode
            eng._launch_decode = lambda active: (rows.append(len(active)), real(active))[1]

        runs.append(_run(api, params, _specs(), setup=spy, chunked_prefill=True, eos_id=eos,
                         pipeline_depth=depth))
        launched.append(sum(rows))
    booked = []
    for run in runs:
        for (rid, _), (toks, _, _) in run[0].items():
            assert len(toks) <= WORKLOAD[rid][1] + 1
            assert eos not in toks[:-1]
        assert run[0][(2, 0)][0] == toks2[: at + 1]
        booked.append(sum(len(toks) - 1 for toks, _, _ in run[0].values()))
    assert launched[0] == booked[0]  # depth 1 books every decode row it launches
    assert launched[1] > booked[1]  # depth 2 dropped the rows launched after an EOS


def test_packed_row_and_use_host_select(packed):
    """The (n_slots, 3+W) row — token, use_host, kv length, block table —
    gives the same logits whether a row's token comes from the host column
    or from the device chain, and the same as ``paged_decode_fn`` fed the
    old way (tokens, tables and lengths apart); argmax, finite mask and
    margin are the logits' own."""
    api, params = _port(packed)
    w = MAX_LEN // PS
    tok = np.array([5, 17, 300, 42], np.int32)
    lens = np.array([3, 0, 9, 1], np.int32)
    tables = np.zeros((SLOTS, w), np.int32)
    tables[0, :1], tables[2, :2], tables[3, :1] = [1], [2, 3], [4]
    pool0 = api.pool_init(6, PS)
    rng = np.random.default_rng(0)
    for n, leaf in pool0.items():  # pages with something in them to read
        if leaf.ndim >= 3:  # selector nibbles < 8 codebooks, scale codes < 127
            hi = 0x78 if n.endswith("_sel") else 120
            leaf.copy_(torch.from_numpy(rng.integers(0, hi, leaf.shape) & (
                0x77 if n.endswith("_sel") else 0xFF)).to(leaf.dtype))
    row = np.concatenate([tok[:, None], np.ones((SLOTS, 1), np.int32), lens[:, None], tables], 1)
    chained = row.copy()
    chained[1:, :2] = 0  # rows 1..3 from the chain (host token 0), row 0 from the host
    chain = torch.from_numpy(np.where(np.arange(SLOTS) >= 1, tok, 999).astype(np.int32))
    want, _ = api.paged_decode_fn(params, {n: t.clone() for n, t in pool0.items()},
                                  torch.from_numpy(tok[:, None]), torch.from_numpy(tables),
                                  torch.from_numpy(lens))
    for pk, ch in ((row, torch.full((SLOTS,), 999, dtype=torch.int32)), (chained, chain)):
        pool = {n: t.clone() for n, t in pool0.items()}
        logits, nxt, fin, margin = fused_decode(api.paged_decode_fn, params, pool,
                                                torch.from_numpy(pk), ch)
        assert torch.equal(logits, want)
        top2 = torch.topk(want[:, -1].float(), 2).values
        assert torch.equal(nxt, want[:, -1].argmax(-1).to(torch.int32))
        assert fin.all() and torch.equal(margin, top2[:, 0] - top2[:, 1])


def test_cuda_graphs_need_a_card(packed):
    """No quiet fallback: graphs asked for on the CPU raise."""
    api, params = _port(packed)
    with pytest.raises(ValueError, match="CUDA"):
        PagedEngine(api, params, device="cpu", cuda_graphs=True, **ENGINE)


# ---------------------------------------------------------- decoded scales
def _stacked_packed_tree(cfg, seed):
    """A layer-stacked tree of packed weights at ``cfg``'s widths with
    random scale bytes (every E4M3 code of a positive scale) and s_W."""
    rng = np.random.default_rng(seed)
    d, f, hd, L = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_layers

    def pk(k, n):
        return {"kernel_packed": {
            "idx": torch.zeros((L, n, k // 2), dtype=torch.uint8),
            "sel": torch.zeros((L, n, k // 16), dtype=torch.uint8),
            "scale": torch.from_numpy(rng.integers(0, 127, (L, n, k // 64)).astype(np.uint8)),
            "s_x": torch.from_numpy(rng.uniform(0.5, 400.0, L).astype(np.float32))}}

    return {"layers": {"attn": {"wq": pk(d, cfg.n_heads * hd), "wk": pk(d, cfg.n_kv_heads * hd),
                                "wv": pk(d, cfg.n_kv_heads * hd), "wo": pk(cfg.n_heads * hd, d)},
                       "mlp": {"wi": pk(d, f), "wo": pk(f, d)}}}


@pytest.mark.parametrize("model", ("smoke", "gpt3_126m"))
def test_decoded_scales_equal_per_call_decode(packed, model):
    """``ptq.decode_scales`` decodes each weight's E4M3 scale bytes once;
    the result equals ``ops.packed_operand``'s per-call decode bit for
    bit, for every weight: the smoke model's packed tree, and random scale
    bytes at full-width gpt3_126m's 72 weights."""
    if model == "smoke":
        tree, n_layers = _port(packed)[1], TCFG.n_layers
    else:
        cfg = t_get_arch("gpt3_126m")
        tree, n_layers = _stacked_packed_tree(cfg, 0), cfg.n_layers
    dec = tptq.decode_scales(tree)
    n = 0
    for blk in ("attn", "mlp"):
        for nm, p in tree["layers"][blk].items():
            pk, dk = p["kernel_packed"], dec["layers"][blk][nm]["kernel_packed"]
            assert "inv_scale" not in pk and dk["idx"] is pk["idx"]  # bytes shared
            for i in range(n_layers):
                per_call = ops.packed_operand({k: v[i] for k, v in pk.items()}).inv_scale
                once = ops.packed_operand({k: v[i] for k, v in dk.items()}).inv_scale
                assert torch.equal(once, dk["inv_scale"][i])
                assert torch.equal(once, per_call), (blk, nm, i)
                n += 1
    assert n == 6 * n_layers
    assert tptq.decode_scales(dec)["layers"]["mlp"]["wi"]["kernel_packed"]["inv_scale"] is \
        dec["layers"]["mlp"]["wi"]["kernel_packed"]["inv_scale"]  # decoded once


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels; no interpret mode)")
    return torch.device("cuda")


def _card_run(cuda, graphs, depth, sampled=False, api=None, params=None):
    trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                   paged_kernel=True, fused_linear=True)
    if api is None:
        api = tzoo.build(TCFG, trt, device=cuda)
        params = api.init(0)
    eng = PagedEngine(api, params, device=cuda, pipeline_depth=depth, cuda_graphs=graphs,
                      chunked_prefill=True, prefix_caching=False, **ENGINE)
    for spec in _specs(sampled):
        eng.submit(_request(tgen, *spec))
    build.reset_counts()
    eng.run_to_completion()
    torch.cuda.synchronize()
    out = {(r.rid, r.sample_idx): (r.out, r.margins, r.launch_ids) for r in eng.finished}
    return out, {k: eng.stats[k] for k in COUNTERS}, build.counts(), eng, api, params


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", (False, True), ids=("greedy", "sampled"))
def test_graph_equals_eager_on_card(cuda, sampled):
    """Graph depth 1 and depth 2 against the eager step at depth 1 on the
    card: tokens, margins, launch indices, counters, pool bytes and kernel
    launch counts (counted per replay) equal."""
    runs = [_card_run(cuda, g, d, sampled) for g, d in ((False, 1), (True, 1), (True, 2))]
    for run in runs[1:]:
        assert run[:3] == runs[0][:3]
        for n, t in runs[0][3].pool.items():
            assert torch.equal(run[3].pool[n], t), n
        assert run[3].trace_counts()["decode"] >= 1
    assert runs[0][3].trace_counts()["decode"] == 0
    assert runs[0][2]["bcq_linear"] == 6 * TCFG.n_layers * (
        runs[0][1]["decode_ticks"] + runs[0][1]["prefill_launches"])


@pytest.mark.cuda
def test_warmed_engine_captures_nothing_new(cuda):
    """One capture per block-table width on a fresh engine; a second run
    through the warmed engine captures none and launches what the first
    did (its schedule does not depend on the tokens)."""
    out, stats, counts, eng, _, _ = _card_run(cuda, True, 2)
    assert eng.trace_counts()["decode"] == len(eng._graphs.buckets) >= 1
    for spec in _specs():
        eng.submit(_request(tgen, *spec))
    before = eng.trace_counts()
    build.reset_counts()
    eng.run_to_completion()
    torch.cuda.synchronize()
    assert eng.trace_counts() == before
    assert len(eng.finished) == 2 * len(out)
    assert build.counts() == counts


@pytest.mark.cuda
def test_containment_adds_no_graph_node(cuda):
    """The decode graph of an engine with containment at its defaults has
    exactly the nodes of one with every containment option on (a fault
    injector, an audit every tick, a bounded queue, the degraded mode, the
    NaN guard off): the guard reads the finite mask the step computes
    anyway, so containment adds no node."""
    from repro_torch.serving.faults import FaultInjector

    trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                   paged_kernel=True, fused_linear=True)
    api = tzoo.build(TCFG, trt, device=cuda)
    params = api.init(0)
    nodes = []
    for extra in ({}, dict(fault_injector=FaultInjector(seed=0), audit_every=1, nan_guard=False,
                           max_queue=16, degrade_after=4)):
        eng = PagedEngine(api, params, device=cuda, pipeline_depth=2, cuda_graphs=True,
                          chunked_prefill=True, prefix_caching=False, **ENGINE, **extra)
        for spec in _specs():
            eng.submit(_request(tgen, *spec))
        eng.run_to_completion()
        torch.cuda.synchronize()
        assert all(r.error is None for r in eng.finished)
        nodes.append({w: eng._graphs.node_count(w) for w in eng._graphs.buckets})
    assert nodes[0] == nodes[1] and nodes[0] and min(nodes[0].values()) > 0, nodes
