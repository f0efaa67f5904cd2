"""The port's serving telemetry held to the reference's: the metrics
registry, ``StatsView``, the request timelines, the Chrome-trace journal
and the LO-BCQ quant-error probes (``repro_torch/serving/telemetry.py``,
``events.py``, ``core/bcq.encode_stats``, the engine's hooks).

The same observations (or the same seeded numpy inputs) go through both
packages' objects: constants, histograms, registries, journals and probe
sinks must give equal snapshots; ``encode_stats`` equal occupancy and an
NMSE within ``NMSE_RTOL``.  Whole engines — the 2-layer smoke gpt3_126m,
W4A4 packed weights, bcq4 pages, chunked admission, the reference at
``paged_kernel=False`` — serve the same greedy workloads: at depth 1 (with
admissions that wait for slots, and with preemption) and at depth 2 where
no admission waits (ROADMAP C: the reference's own depth 2 differs from
its depth 1 under W4A4 there).  Their ``stats``, counters (``device_syncs``
included), gauges, histogram names, edges and counts, journal event counts
and timeline structure are equal; their probe reports equal in sites,
layers, counts and emissions, emission by emission (occupancy equal, NMSE
within ``ENGINE_NMSE_RTOL``) up to the first emission where the two
packages' encodes of the same activation break a codebook tie the other
way (checked: NMSE within ``NMSE_RTOL``, the differing blocks ties) —
after it the tied block's other codeword moves the activations of the
sites that follow — and in (site, layer) NMSE means within
``MEAN_NMSE_RTOL`` over the whole run.  The one combination ROADMAP C
records as a W4A4 ``s_x`` flip between the packages (slab admission with
sampled rows) is not used here.

Both engines carry a probe on one model each (the recorder's or the
relay's sink is swapped per run), so the JAX side compiles one set of
step functions: every run keeps one slot count, one pool and one chunk,
and prompts of 9–16 tokens (one chunk bucket).
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.core import bcq as tbcq
from repro_torch.core.calibrate import default_universal_codebooks as t_codebooks
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import events as tev
from repro_torch.serving import generate as tgen
from repro_torch.serving import telemetry as ttel
from repro_torch.serving.engine import ENGINE_STAT_KEYS, PagedEngine, _host_row_stats, _row_stats
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = t_get_smoke("gpt3_126m")
SLOTS, MAX_LEN, PS, CHUNK, PAGES = 4, 32, 8, 16, 14
ENGINE = dict(n_slots=SLOTS, max_len=MAX_LEN, page_size=PS, prefill_chunk=CHUNK, n_pages=PAGES,
              chunked_prefill=True)
NMSE_RTOL = 1e-6  # encode_stats on one x: f32 sums in another order (XLA's and torch's)
TIE_RTOL = 2e-6  # a block's two codebook errors this close are a tie (f32 sum of 8 squares)
ENGINE_NMSE_RTOL = 1e-5  # one emission of two engines whose activations agree to rounding
MEAN_NMSE_RTOL = 1e-2  # a (site, layer) mean over the run, codebook-tie flips included
# (prompt length, max_new): six requests on four slots retiring at
# different ticks, so that admissions wait for freed slots (depth 1 only)
WAITING = ((9, 6), (12, 3), (10, 8), (14, 4), (11, 5), (13, 6))
TOGETHER = ((9, 6),) * SLOTS  # start and retire together: depth 2 as well
# 4 pages each at the end, 13 in the pool: two preemptions, every chunk in
# the one chunk bucket (the resumed prompts grow the block tables once)
PREEMPT = ((9, 14), (12, 14), (11, 14), (14, 14))
TIMES = ("t_prefill_s", "t_decode_s")


# ----------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def ref():
    """The reference package (the parity side)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import get_smoke
    from repro.core import bcq, ptq
    from repro.core.bcq import BCQConfig
    from repro.core.calibrate import default_universal_codebooks
    from repro.models import zoo
    from repro.models.layers import Runtime
    from repro.serving import events, generate, telemetry
    from repro.serving.engine import PagedEngine as Engine

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=get_smoke("gpt3_126m"), ptq=ptq, bcq=bcq,
                           bcq_cfg=BCQConfig(), zoo=zoo, Runtime=Runtime, gen=generate,
                           Engine=Engine, events=events, tel=telemetry,
                           cb=default_universal_codebooks(BCQConfig()).as_jnp())


class _Relay:
    """A probe sink whose target a test swaps (a model's Runtime is fixed)."""

    target = None

    def __call__(self, site, nmse, occupancy):
        self.target(site, nmse, occupancy)


@pytest.fixture(scope="module")
def models(ref):
    """One W4A4 model per package on the reference's seeded packed tree,
    each with a probe; and the port's model without one."""
    rt = ref.Runtime(quant_mode="none", compute_dtype=ref.jnp.float32,
                     param_dtype=ref.jnp.float32)
    params = ref.zoo.build(ref.cfg, rt).init(ref.jax.random.PRNGKey(0))
    tree = ref.ptq.pack_params(params, ref.cb, ref.bcq_cfg)
    tree["codebooks"] = ref.cb
    packed = ref.jax.tree.map(np.asarray, tree)
    relay = _Relay()
    jrt = ref.Runtime(quant_mode="packed", compute_dtype=ref.jnp.float32,
                      param_dtype=ref.jnp.float32, cache_kind="bcq4", paged_kernel=False,
                      fused_linear=True, quant_probe=relay)
    recorder = ttel.QuantProbeRecorder(None)

    def port(probe):
        trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                       paged_kernel=True, fused_linear=True, quant_probe=probe)
        return tzoo.build(TCFG, trt, device="cpu")

    return SimpleNamespace(japi=ref.zoo.build(ref.cfg, jrt), jtree=ref.jax.tree.map(
        ref.jnp.asarray, packed), relay=relay, api=port(recorder), plain=port(None),
        recorder=recorder, params=from_numpy_tree(packed))


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, TCFG.vocab, n).astype(np.int64)


def _submit(mod, eng, workload, fork=False):
    """Greedy requests; with ``fork`` the first forks in 3 (greedy siblings:
    the timelines do not depend on the draw, and the reference then
    compiles no sampler)."""
    for rid, (n, max_new) in enumerate(workload):
        eng.submit(mod.Request(rid=rid, prompt=_tokens(n, rid), max_new=max_new,
                               n_samples=3 if fork and rid == 0 else 1))


def _port_run(models, workload, probe=True, fork=False, telemetry=None, **kw):
    """A port engine (CPU) over ``workload`` to completion; with ``probe`` a
    fresh sink gets its emissions.  Returns (engine, sink or None, emissions)."""
    sink, log = ttel.QuantProbeSink(n_layers=TCFG.n_layers), []
    models.recorder.sink = lambda *a: (log.append(a), sink(*a))
    eng = PagedEngine(models.api if probe else models.plain, models.params, device="cpu",
                      telemetry=telemetry, **{**ENGINE, **kw})
    _submit(tgen, eng, workload, fork)
    eng.run_to_completion()
    assert not eng._inflight and all(r.error is None for r in eng.finished)
    return eng, (sink if probe else None), log


def _captured_port_run(models, workload, **kw):
    """``_port_run`` with probes, keeping every probe site's activation:
    (engine, sink, emissions, activations)."""
    xs = []
    record = models.recorder.record
    models.recorder.record = lambda site, x, cb, cfg: (xs.append(x.numpy().copy()),
                                                       record(site, x, cb, cfg))
    try:
        return (*_port_run(models, workload, **kw), xs)
    finally:
        del models.recorder.record


@pytest.fixture(scope="module")
def waiting(models):
    """The port with probes on WAITING at depth 1, shared by the tests that
    read it (the run is deterministic)."""
    return _captured_port_run(models, WAITING, pipeline_depth=1)


def _ref_run(ref, models, workload, fork=False, **kw):
    sink, log = ref.tel.QuantProbeSink(n_layers=TCFG.n_layers), []
    models.relay.target = lambda *a: (log.append(a), sink(*a))
    eng = ref.Engine(models.japi, models.jtree, **{**ENGINE, **kw})
    _submit(ref.gen, eng, workload, fork)
    eng.run_to_completion()
    return eng, sink, log


def _outputs(eng):
    return {(r.rid, r.sample_idx): list(r.out) for r in eng.finished}


def _timeline_shape(eng):
    return {(tl.rid, tl.sample_idx): (tl.t_submit <= tl.admits[0], len(tl.admits),
                                      len(tl.chunks), len(tl.prefill_spans), tl.n_tokens,
                                      tl.preemptions, tl.t_first is not None,
                                      tl.t_finish is not None)
            for tl in eng.telemetry.timelines}


def _hold_engines(jeng, teng):
    """Everything two engines on one workload must share beyond tokens."""
    assert _outputs(jeng) == _outputs(teng)
    assert dict(teng.stats).keys() == dict(jeng.stats).keys() == set(ENGINE_STAT_KEYS)
    assert {k: teng.stats[k] for k in ENGINE_STAT_KEYS if k not in TIMES} == \
        {k: jeng.stats[k] for k in ENGINE_STAT_KEYS if k not in TIMES}
    js, ts = jeng.snapshot(), teng.snapshot()
    json.dumps(ts)
    for part in ("schema", "level", "trace_counts"):
        assert part in ts
    assert ts["schema"] == js["schema"] and ts["level"] == js["level"]
    assert ts["counters"].keys() == js["counters"].keys()
    assert {k: v for k, v in ts["counters"].items() if k not in TIMES} == \
        {k: v for k, v in js["counters"].items() if k not in TIMES}
    assert ts["counters"]["device_syncs"] > 0
    assert ts["gauges"] == js["gauges"]
    assert ts["histograms"].keys() == js["histograms"].keys()
    for name, h in ts["histograms"].items():
        assert h["buckets"] == js["histograms"][name]["buckets"], name
        assert h["count"] == js["histograms"][name]["count"], name
    assert ts["journal"]["events"] == js["journal"]["events"]
    assert ts["timelines"]["count"] == js["timelines"]["count"]
    assert _timeline_shape(teng) == _timeline_shape(jeng)


# ------------------------------------------------------------ the constants
def test_constants_equal_reference(ref):
    for name in ("SCHEMA_VERSION", "TTFT_BUCKETS", "ITL_BUCKETS", "QUEUE_BUCKETS",
                 "LAUNCH_BUCKETS", "NMSE_BUCKETS", "ENGINE_STAT_KEYS", "ROBUSTNESS_STAT_KEYS",
                 "SWAP_STAT_KEYS"):
        assert getattr(ttel, name) == getattr(ref.tel, name), name
    for name in ("SCHEMA_VERSION", "TID_HOST", "TID_DEVICE", "_THREAD_NAMES"):
        assert getattr(tev, name) == getattr(ref.events, name), name
    assert ttel.Telemetry.LEVELS == ref.tel.Telemetry.LEVELS


# ------------------------------------------------------------ registry units
def _observations(seed, n=200):
    """Seeded values across every bucket, edges included."""
    rng = np.random.default_rng(seed)
    vals = list(10.0 ** rng.uniform(-5, 1.5, n)) + list(ttel.TTFT_BUCKETS) + [0.0]
    return [float(v) for v in vals]


@pytest.mark.parametrize("edges", ("TTFT_BUCKETS", "ITL_BUCKETS", "QUEUE_BUCKETS",
                                   "NMSE_BUCKETS"))
def test_histogram_equals_reference(ref, edges):
    a = ttel.Histogram("x", getattr(ttel, edges), "s")
    b = ref.tel.Histogram("x", getattr(ref.tel, edges), "s")
    for v in _observations(len(edges)):
        a.observe(v)
        b.observe(v)
    assert a.snapshot() == b.snapshot()
    assert ttel.Histogram("y", (1.0,)).mean() == 0.0


def test_registry_equals_reference(ref):
    regs = (ttel.MetricsRegistry(), ref.tel.MetricsRegistry())
    for reg in regs:
        c = reg.counter("hits")
        c.inc()
        c.inc(3)
        reg.counter("t_s", "s").inc(0.25)
        reg.gauge("depth").set(7)
        for v in _observations(1, 20):
            reg.histogram("lat", ttel.LAUNCH_BUCKETS, "s").observe(v)
        assert reg.counter("hits") is c
        with pytest.raises(AssertionError):  # edges never change silently
            reg.histogram("lat", (0.5, 1.0))
    assert regs[0].snapshot() == regs[1].snapshot()


@pytest.mark.parametrize("sample_every", (1, 2, 3))
def test_quant_probe_sink_equals_reference(ref, sample_every):
    """Layer attribution (arrival count mod n_layers per site) and the
    ``sample_every`` decimation of launches: equal reports."""
    sinks = (ttel.QuantProbeSink(n_layers=3, sample_every=sample_every),
             ref.tel.QuantProbeSink(n_layers=3, sample_every=sample_every))
    rng = np.random.default_rng(sample_every)
    for _ in range(7):  # launches
        for site in ("attn_qkv", "attn_out", "mlp_in", "mlp_out"):
            for _layer in range(3):
                nmse, occ = float(rng.uniform(1e-4, 1e-2)), rng.integers(0, 50, 8)
                for s in sinks:
                    s(site, nmse, occ.astype(np.int32))
    assert sinks[0].report() == sinks[1].report()
    assert sinks[0].total_emissions == 7 * 4 * 3


# -------------------------------------------------------------- the journal
@pytest.mark.parametrize("capacity", (4, 64))
def test_journal_equals_reference(ref, capacity):
    """The same spans and instants give equal Chrome traces; the ring drops
    the oldest records as the reference's does."""
    js = (tev.TraceJournal(capacity=capacity), ref.events.TraceJournal(capacity=capacity))
    rng = np.random.default_rng(capacity)
    t = 100.0
    for k in range(20):
        t0, t = t, t + float(rng.uniform(1e-4, 1e-2))
        for j in js:
            if k % 3 == 2:
                j.instant("preempt", t0, args={"rid": k})
            else:
                j.span("decode_tick" if k % 2 else "prefill_launch", t0, t,
                       tid=tev.TID_DEVICE, args={"n_active": k} if k % 4 else None)
    a, b = (j.to_chrome_trace() for j in js)
    assert a == b
    json.loads(json.dumps(a))
    assert js[0].dropped == js[1].dropped == 20 - min(capacity, 20)
    assert js[0].counts() == js[1].counts() and len(js[0]) == min(capacity, 20)
    off = tev.TraceJournal(capacity=capacity, enabled=False)
    off.span("tick", 1.0, 2.0)
    off.instant("evt")
    assert len(off) == 0 and off.total == 0
    assert all(e["ph"] == "M" for e in off.to_chrome_trace()["traceEvents"])


def test_counters_level_hooks_are_noops():
    tel = ttel.Telemetry(level="counters")
    req = tgen.Request(rid=0, prompt=np.zeros(4, np.int64), max_new=2)
    tel.on_submit(req, 1.0)
    assert req.timeline is None and len(tel.timelines) == 0
    tel.prefill_launch(1.0, 2.0)
    tel.decode_tick(2.0, 3.0)
    tel.decode_sync(3.0, 4.0)
    tel.decode_gap(0.5)
    tel.instant("preempt", 1.0)
    assert tel.h_prefill.count == tel.h_decode.count == tel.h_decode_sync.count == 0
    assert tel.h_host_gap.count == 0 and len(tel.journal) == 0


# ------------------------------------------------------------- encode_stats
@pytest.mark.parametrize("s_x", (None, 0.7), ids=("own-scale", "given-scale"))
@pytest.mark.parametrize("shape", ((4, 128), (7, 100), (3, 197), (16, 768), (2, 3, 64)))
def test_encode_stats_equals_reference(ref, shape, s_x):
    """NMSE of the round trip (array padding excluded) within NMSE_RTOL and
    the selector occupancy (padded blocks counted) equal, ragged K
    included; on normal values, where XLA's CPU flush of subnormals cannot
    reorder a threshold compare (ROADMAP C)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., :: 7] *= 12.0  # outlier channels
    jn, jo = ref.bcq.encode_stats(ref.jnp.asarray(x), ref.cb, ref.bcq_cfg,
                                  None if s_x is None else ref.jnp.float32(s_x))
    cb = t_codebooks().as_tensor()
    tn, to = tbcq.encode_stats(torch.from_numpy(x), cb, tbcq.BCQConfig(),
                               None if s_x is None else torch.tensor(s_x, dtype=torch.float32))
    assert to.dtype == torch.int64 and to.tolist() == np.asarray(jo).tolist()
    n_arrays = -(-shape[-1] // 64) * int(np.prod(shape[:-1]))
    assert int(to.sum()) == n_arrays * 8  # every block of every padded array
    assert float(tn) == pytest.approx(float(jn), rel=NMSE_RTOL, abs=0)
    assert float(tbcq.quantization_nmse(torch.from_numpy(x), torch.zeros(shape))) == 1.0


def test_recorder_rows_follow_the_sites(models):
    """The recorder writes a launch's sites in order into its buffers and
    feeds them back in that order; a launch that fires other sites raises."""
    got = []
    rec = ttel.QuantProbeRecorder(lambda *a: got.append(a))
    cb, cfg = t_codebooks().as_tensor(), tbcq.BCQConfig()
    xs = [torch.from_numpy(np.random.default_rng(k).standard_normal((5, 128)).astype(np.float32))
          for k in range(3)]
    rec.begin()
    for k, x in enumerate(xs):
        rec.record(f"s{k}", x, cb, cfg)
    rec.feed(rec.fetch())
    assert [a[0] for a in got] == ["s0", "s1", "s2"]
    for (_, nmse, occ), x in zip(got, xs):
        want = tbcq.encode_stats_plain(x, cb, cfg)
        assert nmse == float(want[0]) and occ.tolist() == want[1].tolist()
    rec.begin()
    with pytest.raises(RuntimeError, match="same sites"):
        rec.record("s1", xs[0], cb, cfg)


# ------------------------------------------------- the one-fetch row stats
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_host_row_stats_one_fetch_equals_three(seed):
    """The prefill's one fetch of (token, finite flag, margin) gives the
    bits of the three fetches it replaced, non-finite rows included."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((5, 3, 97), generator=g) * 10
    logits[1, -1, 3] = float("nan")
    logits[3, -1, 7] = float("inf")
    nxt, fin, margin = _host_row_stats(logits)
    want = [t.cpu().numpy() for t in _row_stats(logits)]
    assert np.array_equal(nxt, want[0]) and nxt.dtype == np.int32
    assert np.array_equal(fin, want[1]) and fin.dtype == np.bool_
    assert margin.dtype == np.float32
    assert np.array_equal(margin.view(np.int32), want[2].view(np.int32))


# -------------------------------------------------- engines against engines
def _tie_blocks(ref, x: np.ndarray) -> int:
    """The blocks of x (M, K) where the two packages' encodes choose other
    codebooks, each checked to be a tie: its two block errors (f64, from
    the port's normalized values) within TIE_RTOL — XLA sums a block's
    eight squares in another order, so a near tie can break the other way
    (ROADMAP C).  Returns their number."""
    cb, cfg = t_codebooks().as_tensor(), tbcq.BCQConfig()
    xt = torch.from_numpy(x)
    s_x = tbcq.tensor_scale(xt, cfg)
    tsel = tbcq.unpack_nibbles(tbcq.encode(xt, cb, cfg, s_x).packed_sel)
    jsel = tbcq.unpack_nibbles(torch.from_numpy(np.array(
        ref.bcq.encode(ref.jnp.asarray(x), ref.cb, ref.bcq_cfg).packed_sel)))
    xp, _ = tbcq.pad_to_multiple(xt, cfg.array_len)
    arrays = xp.reshape(xp.shape[0], -1, cfg.array_len)
    _, scale = tbcq._array_scales(arrays, cfg, s_x)
    y = (arrays * scale[..., None]).reshape(xp.shape[0], -1, cfg.block_len)
    diff = (tsel[:, : y.shape[1]] != jsel[:, : y.shape[1]]).nonzero().tolist()
    for r, b in diff:
        errs = []
        for c in (int(tsel[r, b]), int(jsel[r, b])):
            q = cb[c][tbcq.nearest_level_idx(y[r, b], cb[c])]
            errs.append(float(((y[r, b].double() - q.double()) ** 2).sum()))
        assert abs(errs[0] - errs[1]) <= TIE_RTOL * max(errs), (r, b, errs)
    return len(diff)


@pytest.mark.parametrize("depth,workload", ((1, WAITING), (2, TOGETHER)),
                         ids=("depth1-waiting", "depth2-together"))
def test_engine_equals_reference(request, ref, models, depth, workload):
    """Tokens, stats, counters (device_syncs included), gauges, histogram
    names / edges / counts, journal event counts and timeline structure
    equal; the probe reports equal in sites, layers, counts and emissions.

    Engine against engine, emission by emission: occupancy equal and NMSE
    within ENGINE_NMSE_RTOL (the activations agree to rounding) up to the
    first emission where the two packages' encodes of the same x break a
    codebook tie the other way (checked on the port's x: NMSE within
    NMSE_RTOL, the differing blocks ties, ``_tie_blocks``) — its block's
    other codeword moves the sites after it; every (site, layer)'s NMSE
    mean within MEAN_NMSE_RTOL over the run."""
    if depth == 1:
        teng, tsink, tlog, xs = request.getfixturevalue("waiting")
    else:
        teng, tsink, tlog, xs = _captured_port_run(models, workload, pipeline_depth=depth)
    jeng, jsink, jlog = _ref_run(ref, models, workload, pipeline_depth=depth)
    _hold_engines(jeng, teng)
    assert teng.telemetry.h_ttft.count == len(workload)
    assert teng.telemetry.h_itl.count == sum(len(r.out) - 1 for r in teng.finished)
    if depth == 2:
        assert teng.telemetry.h_decode_sync.count == teng.stats["decode_ticks"]

    ja, ta = jsink.report(), tsink.report()
    assert ta["emissions"] == ja["emissions"] == len(xs) == teng._launches * 4 * TCFG.n_layers
    assert [s for s, _, _ in tlog] == [s for s, _, _ in jlog]
    assert ta["sites"].keys() == ja["sites"].keys() == {"attn_qkv", "attn_out", "mlp_in",
                                                       "mlp_out"}
    first_tie = len(xs)
    for k, x in enumerate(xs):
        if tlog[k][2].tolist() == np.asarray(jlog[k][2]).tolist() and tlog[k][1] == \
                pytest.approx(float(jlog[k][1]), rel=ENGINE_NMSE_RTOL, abs=0):
            continue
        jn, jo = ref.bcq.encode_stats(ref.jnp.asarray(x), ref.cb, ref.bcq_cfg)
        assert tlog[k][1] == pytest.approx(float(jn), rel=NMSE_RTOL, abs=0), k
        assert tlog[k][2].tolist() != np.asarray(jo).tolist() and _tie_blocks(ref, x) > 0, k
        first_tie = k
        break
    assert first_tie >= len(xs) // 2  # the comparison covers most of the run
    for site, per in ta["sites"].items():
        assert per.keys() == ja["sites"][site].keys() == {str(i) for i in range(TCFG.n_layers)}
        for layer, agg in per.items():
            want = ja["sites"][site][layer]
            assert agg["count"] == want["count"]
            assert sum(agg["cluster_occupancy"]) == sum(want["cluster_occupancy"])
            assert agg["nmse_mean"] == pytest.approx(want["nmse_mean"], rel=MEAN_NMSE_RTOL)


def test_preemption_timelines_equal_reference(ref, models):
    """A preempted request keeps ONE timeline: one submit, an admit per
    (re)admission, TTFT from the original submit; as the reference's."""
    jeng, _, _ = _ref_run(ref, models, PREEMPT, watermark=0)
    teng, _, _ = _port_run(models, PREEMPT, watermark=0)
    assert teng.stats["preemptions"] > 0
    _hold_engines(jeng, teng)
    tls = list(teng.telemetry.timelines)
    assert len(tls) == len(PREEMPT) == len({tl.rid for tl in tls})
    fin = {r.rid: r for r in teng.finished}
    pre = [tl for tl in tls if tl.preemptions]
    assert pre
    for tl in tls:
        assert tl.n_tokens == len(fin[tl.rid].out)
        assert len(tl.admits) == 1 + tl.preemptions and tl.admits == sorted(tl.admits)
        assert tl.t_submit <= tl.admits[0] <= tl.t_first <= tl.t_finish
    assert teng.telemetry.h_queue.count == sum(len(tl.admits) for tl in tls)
    assert teng.telemetry.journal.counts()["preempt"] == teng.stats["preemptions"]


def test_fork_timelines_share_the_prefill(ref, models):
    """Forked siblings: their own timelines (tokens, TTFT) sharing the
    parent's prefill-span list; as the reference's."""
    jeng, _, _ = _ref_run(ref, models, TOGETHER[:1], fork=True)
    teng, _, _ = _port_run(models, TOGETHER[:1], fork=True)
    assert teng.stats["forks"] == 1
    assert _timeline_shape(teng) == _timeline_shape(jeng)
    tls = [tl for tl in teng.telemetry.timelines if tl.rid == 0]
    parent = next(tl for tl in tls if tl.sample_idx == 0)
    children = [tl for tl in tls if tl.sample_idx]
    assert len(children) == 2
    for ch in children:
        assert ch is not parent and ch.prefill_spans is parent.prefill_spans
        assert ch.t_submit == parent.t_submit and ch.ttft() is not None
    assert teng.telemetry.h_ttft.count == 3


# ------------------------------------------------------------- port engines
def test_telemetry_leaves_tokens_and_syncs_alone(models, waiting):
    """At the "counters" level, the default level and with probes on, the
    same tokens, margins, launch indices, counters and pool bytes; the
    same device_syncs; the counters level records no timeline and no
    journal event."""
    runs = [_port_run(models, WAITING, probe=False, telemetry=ttel.Telemetry(level))[0]
            for level in ("counters", "default")] + [waiting[0]]
    base = runs[0]
    for eng in runs[1:]:
        assert {(r.rid, r.sample_idx): (r.out, r.margins, r.launch_ids) for r in eng.finished} \
            == {(r.rid, r.sample_idx): (r.out, r.margins, r.launch_ids) for r in base.finished}
        assert {k: eng.stats[k] for k in ENGINE_STAT_KEYS if k not in TIMES} == \
            {k: base.stats[k] for k in ENGINE_STAT_KEYS if k not in TIMES}
        assert all(torch.equal(eng.pool[n], base.pool[n]) for n in base.pool)
        syncs = eng.telemetry.registry.counter("device_syncs").value
        assert syncs == base.telemetry.registry.counter("device_syncs").value > 0
    assert len(base.telemetry.timelines) == 0 and len(base.telemetry.journal) == 0
    assert base.snapshot()["level"] == "counters"


def test_probe_reports_equal_across_depths(models, waiting):
    """The probe rows of every launch are fed in launch order at any depth:
    depth 2 and depth 1 give equal reports, emission for emission."""
    runs = [waiting, _port_run(models, WAITING, pipeline_depth=2)]
    assert runs[0][1].report() == runs[1][1].report()
    assert [(s, n, o.tolist()) for s, n, o in runs[0][2]] == \
        [(s, n, o.tolist()) for s, n, o in runs[1][2]]


def test_stats_view_and_health_read_the_registry(models):
    eng, _, _ = _port_run(models, TOGETHER, probe=False)
    assert isinstance(eng.stats, ttel.StatsView)
    assert list(eng.stats) == list(ENGINE_STAT_KEYS) and len(eng.stats) == len(ENGINE_STAT_KEYS)
    assert eng.stats["peak_pages"] == eng.pool_mgr.peak > 0
    with pytest.raises(KeyError):
        eng.stats["no_such_stat"]
    with pytest.raises(TypeError):
        eng.stats["forks"] = 1
    reg = eng.telemetry.registry
    assert eng.stats["decode_ticks"] == reg.counter("decode_ticks").value > 0
    reg.counter("shed").inc(2)
    assert eng.health()["counters"]["shed"] == 2
    assert eng.health()["swap"] == {k: 0 for k in ttel.SWAP_STAT_KEYS}
    g = eng.snapshot()["gauges"]
    assert g["pool_pages_kv"] + g["pool_pages_state"] + g["pool_pages_shared_ro"] \
        == g["pool_pages_used"]


def test_cli_artifacts_pass_check_telemetry(tmp_path):
    """``launch.serve --metrics-json --trace-out --quant-probes`` on the CPU:
    the unchanged tools/check_telemetry.py accepts both files."""
    metrics, trace = tmp_path / "m.json", tmp_path / "t.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--smoke",
         "--paged", "--packed", "--chunked-prefill", "--quant-probes", "--batch", "2",
         "--prompt-len", "20", "--gen", "5", "--page-size", "8", "--metrics-json", str(metrics),
         "--trace-out", str(trace)], env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "quant-probes: " in out.stdout and "telemetry: ttft mean" in out.stdout
    check = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "check_telemetry.py"),
                            str(metrics), str(trace)], capture_output=True, text=True, timeout=60)
    assert check.returncode == 0, check.stdout + check.stderr
    snap = json.loads(metrics.read_text())
    assert snap["quant_probes"]["emissions"] == snap["counters"]["prefill_launches"] * 8 + \
        snap["counters"]["decode_ticks"] * 8


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the quantize kernel and CUDA graphs; no interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((8, 768), (8, 3072), (37, 200), (2, 5, 128)))
def test_encode_stats_kernel_equals_plain_on_card(cuda, shape):
    """The probe's route through the quantize kernel against the plain
    ``encode``, on one x: NMSE within NMSE_RTOL and occupancy equal (the
    two encodes are bit-exact but on codebook ties)."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda)
    x[..., :: 7] *= 12.0
    cb, cfg = t_codebooks().as_tensor(cuda), tbcq.BCQConfig()
    kn, ko = tbcq.encode_stats(x, cb, cfg)
    pn, po = tbcq.encode_stats_plain(x, cb, cfg)
    assert ko.device.type == "cuda" and ko.tolist() == po.tolist()
    assert float(kn) == pytest.approx(float(pn), rel=NMSE_RTOL, abs=0)


@pytest.mark.cuda
def test_probe_graph_equals_eager_on_card(cuda):
    """With a probe on the model, graph depth 2 and eager depth 1 give the
    same tokens and the same probe emissions bit for bit; the probe graph
    has more nodes than the default one, and B3 launches 4 times a layer
    and pass (counted per replay)."""
    from repro_torch.kernels import build

    sinks = []
    rec = ttel.QuantProbeRecorder(None)
    apis = {}
    for probe in (None, rec):
        trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                       paged_kernel=True, fused_linear=True, quant_probe=probe)
        apis[probe is not None] = tzoo.build(TCFG, trt, device=cuda)
    params = apis[False].init(0)
    runs = []
    for probe, graphs, depth in ((True, False, 1), (True, True, 2), (False, True, 2)):
        log = []
        rec.sink = lambda *a, log=log: log.append((a[0], a[1], a[2].tolist()))
        sinks.append(log)
        eng = PagedEngine(apis[probe], params, device=cuda, pipeline_depth=depth,
                          cuda_graphs=graphs, **ENGINE)
        _submit(tgen, eng, WAITING)
        build.reset_counts()
        eng.run_to_completion()
        torch.cuda.synchronize()
        passes = eng.stats["decode_ticks"] + eng.stats["prefill_launches"]
        assert build.counts().get("bcq_quantize", 0) == (4 * TCFG.n_layers * passes if probe
                                                         else 0)
        runs.append((_outputs(eng), eng))
    assert runs[0][0] == runs[1][0] == runs[2][0]
    assert sinks[0] == sinks[1] and len(sinks[0]) > 0 and not sinks[2]
    nodes = [{w: e._graphs.node_count(w) for w in e._graphs.buckets} for _, e in runs[1:]]
    assert nodes[0].keys() == nodes[1].keys() and all(nodes[0][w] > nodes[1][w] for w in nodes[0])
