"""The port's hybrid (``recurrentgemma_9b``) served through
``StatePagedEngine`` against the JAX package's engine, on the 3-layer
smoke with a bcq4 ring (window 32) — the port's counterparts of
``tests/test_state_paged.py``'s ``recurrentgemma_9b`` cases, and the
hybrid cache tree under the state-page ops.

Both packages serve the port's seeded weights (``zoo.build(...).init(0)``,
packed by the port's ``pack_params``, whose bytes the model file holds to
the reference's), carried into the reference as numpy arrays, with
numpy-seeded 20-token prompts; every engine here has 4 slots,
max_len 64 and page 8, and a request's 19 new tokens carry it past the
window, so the ring wraps while it decodes.  One JAX model per mode
(``lru_cache``), so the reference compiles its step functions once a
shape.

Held here:

* paged ≡ contiguous at depths 1 and 2 (``quant_mode="none"``): the
  port's tokens equal the port's ``greedy_generate`` and the reference
  engine's, bit for bit; no ``kv`` page is held;
* W4A4 (``packed``): port engine vs reference engine under the margin
  rule (``TOL`` 1e-3; the port's margins judge both), counters equal; the
  port's depth 2 equal to its depth 1 bit for bit (tokens, margins,
  launch ids, counters, live tree and state pool bytes);
* bounded replay at depths 1 and 2: 0 < replayed ≤ page_size tokens,
  bit-identical at ``none``; under W4A4 the preempted run held to the
  reference's own preempted run by the margin rule, the flips against the
  never-preempted run counted (a batch-1 replay launch has its own
  activation scale);
* the host tier: zero-replay resume, bit-identical, the state page's
  arrays and digest equal to the reference's fetch of the same bytes and
  back bit for bit;
* a greedy fork identical, a sampled fork reproducible; the reference
  CI's hot chaos schedule (seed 3, rate 0.2, audit every tick) contained
  with its report through ``tools/check_chaos.py``; the serve CLI
  contiguous and ``--paged``;
* the tree ops: batch axes (``k_sx`` / ``v_sx`` ``REPLICATED``), pool init,
  checkpoint with duplicate null-page rows, restore, extract, insert,
  copy, fetch and digest equal to the reference's bit for bit.

Every port engine built here is audited at teardown (``_audit_state_engines``).
"""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.models import hybrid as thyb
from repro_torch.models import zoo as tzoo
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import generate as tgen
from repro_torch.serving import pages as tpages
from repro_torch.serving.audit import audit_engine
from repro_torch.serving.state_engine import StatePagedEngine

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke  # noqa: E402
from repro.models import hybrid as jhyb  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro.serving import generate as jgen  # noqa: E402
from repro.serving import pages as jpages  # noqa: E402
from repro.serving.state_engine import StatePagedEngine as JStateEngine  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma_9b"
CFG, TCFG = get_smoke(ARCH), t_get_smoke(ARCH)
SLOTS, ML, PS, S, GEN = 4, 64, 8, 20, 19
TOL = 1e-3
STAT_KEYS = ("prefill_launches", "prefill_tokens", "decode_ticks", "forks", "shared_pages",
             "preemptions")


@pytest.fixture(autouse=True)
def _audit_state_engines(monkeypatch):
    """Every port engine built in a test ends it drained, with a clean audit."""
    built = []
    real = StatePagedEngine.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(StatePagedEngine, "__init__", init)
    yield
    for eng in built:
        assert not eng._inflight, "a launch left in flight at teardown"
        report = audit_engine(eng)
        assert report.ok, report.violations


def _rts(mode):
    return (JRuntime(quant_mode=mode, compute_dtype=jnp.float32, param_dtype=jnp.float32,
                     cache_kind="bcq4"),
            TRuntime(quant_mode=mode, compute_dtype=torch.float32, cache_kind="bcq4"))


def _to_reference(tree):
    """A port tree as the reference's: numpy-carried leaves, without the
    decoded ``inv_scale`` the port keeps beside each packed weight."""
    if isinstance(tree, dict):
        return {k: _to_reference(v) for k, v in tree.items() if k != "inv_scale"}
    return jnp.asarray(tree.numpy())


@functools.lru_cache(maxsize=None)
def _models(mode):
    """(reference api, its params, port api, its params) for ``mode``: the
    port's seeded draw (packed by the port's ``pack_params``, byte for byte
    the reference's: tests/test_torch_hybrid.py), carried into the
    reference; the trees carry the codebooks (the bcq4 ring reads them at
    any mode)."""
    jrt, trt = _rts(mode)
    tapi = tzoo.build(TCFG, trt, device="cpu")
    tparams = tapi.init(0)
    return jzoo.build(CFG, jrt), _to_reference(tparams), tapi, tparams


def _prompts(n=3, seed=5):
    return [np.random.default_rng(seed + i).integers(0, CFG.vocab, S) for i in range(n)]


def _engine(mode, **kw):
    kw.setdefault("n_slots", SLOTS)
    _, _, tapi, tparams = _models(mode)
    return StatePagedEngine(tapi, tparams, max_len=ML, page_size=PS, device="cpu", **kw)


def _ref_engine(mode, **kw):
    japi, jparams, _, _ = _models(mode)
    return JStateEngine(japi, jparams, n_slots=SLOTS, max_len=ML, page_size=PS, **kw)


def _serve(eng, gen, prompts, max_new=GEN, **req):
    reqs = [gen.Request(rid=i, prompt=p, max_new=max_new, **req) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return reqs


def _preempted(eng, gen, prompt, rid=1, ticks=9, max_new=GEN):
    """One request, preempted mid-generation after ``ticks`` steps, served
    to the end.  Returns (request, tokens it had before the preemption)."""
    r = gen.Request(rid=rid, prompt=prompt, max_new=max_new)
    eng.submit(r)
    for _ in range(ticks):
        eng.step()
    eng.drain()
    n_before = len(r.out)
    assert 0 < n_before < max_new + 1, "must preempt mid-generation"
    assert eng._preempt_one(None) is not None
    assert audit_engine(eng).ok  # the carried checkpoint stays accounted
    eng.run_to_completion()
    return r, n_before


def _agree(jfin, tfin):
    """The margin rule over port vs reference requests (the port's margins
    and launches judge both)."""
    got = {(r.rid, r.sample_idx): r for r in tfin}
    ref = {k: SimpleNamespace(out=list(map(int, r.out)), launch_ids=list(got[k].launch_ids),
                              margins=[0.0] * len(r.out))
           for r in jfin for k in [(r.rid, r.sample_idx)]}
    return tgen.greedy_agreement(ref, got, TOL)


def _outcome(eng, reqs):
    return ([(r.out, r.margins, r.launch_ids, None if r.error is None else r.error.kind)
             for r in reqs],
            {k: v for k, v in eng.stats.items() if not k.startswith("t_")},  # no clocks
            eng.health()["state_counters"], eng.health()["swap"],
            [tpages.tree_leaves(t) for t in (eng.live, eng.spool)])


def _same_outcome(a, b):
    assert a[:4] == b[:4]
    for ta, tb in zip(a[4], b[4]):
        for x, y in zip(ta, tb):
            assert torch.equal(x, y)


# ------------------------------------------------------- token equivalence
@functools.lru_cache(maxsize=None)
def _ref_tokens(mode):
    """The reference engine's tokens and counters on the 3-prompt workload."""
    eng = _ref_engine(mode)
    reqs = _serve(eng, jgen, _prompts())
    return [list(map(int, r.out)) for r in reqs], {k: eng.stats[k] for k in STAT_KEYS}, reqs


@pytest.mark.parametrize("depth", [1, 2])
def test_state_paged_matches_contiguous(depth):
    _, _, tapi, tparams = _models("none")
    prompts = _prompts()
    contiguous = tgen.greedy_generate(tapi, tparams, np.stack(prompts), GEN + 1, ML,
                                      device="cpu")
    eng = _engine("none", pipeline_depth=depth)
    reqs = _serve(eng, tgen, prompts)
    ref, stats, _ = _ref_tokens("none")
    for i, r in enumerate(reqs):
        assert r.done and r.error is None
        assert r.out == contiguous[i].tolist() == ref[i], i
    assert {k: eng.stats[k] for k in STAT_KEYS} == stats
    assert eng.pool_mgr.used_by_kind()["kv"] == 0
    assert eng.health()["state_counters"]["state_checkpoints"] > len(prompts)
    assert S + GEN > CFG.hybrid.window  # the ring wrapped while decoding


def test_packed_engine_matches_reference_and_depth2_is_depth1():
    """W4A4: the reference engine's tokens under the margin rule and its
    counters; depth 2 ≡ depth 1 bit for bit."""
    ref, stats, jreqs = _ref_tokens("packed")
    outs = {}
    for depth in (1, 2):
        eng = _engine("packed", pipeline_depth=depth)
        reqs = _serve(eng, tgen, _prompts())
        outs[depth] = _outcome(eng, reqs)
        agree = _agree(jreqs, reqs)
        assert agree["ok"], agree
        assert {k: eng.stats[k] for k in STAT_KEYS} == stats
    _same_outcome(outs[1], outs[2])


# ----------------------------------------------- bounded-replay preemption
@pytest.mark.parametrize("depth", [1, 2])
def test_preempt_resume_bounded_replay(depth):
    prompt = _prompts(1)[0]
    e0 = _engine("none", pipeline_depth=depth)
    (r0,) = _serve(e0, tgen, [prompt])
    e1 = _engine("none", pipeline_depth=depth)
    r1, n_before = _preempted(e1, tgen, prompt)
    assert r1.out == r0.out
    cs = e1.health()["state_counters"]
    assert cs["state_restores"] == 1
    assert 0 < cs["replay_tokens"] <= PS
    assert cs["replay_tokens"] < len(prompt) + n_before


def test_packed_replay_matches_reference_and_counts_flips():
    """Under W4A4 the batch-1 replay launches have their own activation
    scales: the port's preempted run equals the reference's preempted run
    under the margin rule; against the never-preempted run the tokens
    agree up to the preemption, and the flips after it are counted."""
    prompt = _prompts(1)[0]
    (r0,) = _serve(_engine("packed"), tgen, [prompt])
    e1 = _engine("packed")
    r1, n_before = _preempted(e1, tgen, prompt)
    j1, _ = _preempted(_ref_engine("packed"), jgen, prompt)
    agree = _agree([j1], [r1])
    assert agree["ok"], agree
    assert r1.out[:n_before] == r0.out[:n_before] and len(r1.out) == len(r0.out)
    assert sum(a != b for a, b in zip(r0.out, r1.out)) <= len(r1.out) - n_before
    assert 0 < e1.health()["state_counters"]["replay_tokens"] <= PS


# ------------------------------------------- host-tier zero-replay resume
def test_preempt_resume_from_host_zero_replay_bitwise():
    """The live row snapshots to a pinned host entry and comes back
    verified: zero tokens replayed, the tokens bit-identical; the staged
    state page's arrays and digest equal the reference's fetch of the same
    bytes, and a page round trip through the tier is bitwise."""
    prompt = _prompts(1)[0]
    (r0,) = _serve(_engine("none"), tgen, [prompt])
    e1 = _engine("none", host_pages=8)
    r = tgen.Request(rid=1, prompt=prompt, max_new=GEN)
    e1.submit(r)
    for _ in range(9):
        e1.step()
    assert e1._preempt_one(None) is not None
    assert e1.health()["swap"]["swap_outs"] == 1
    assert e1.health()["host_tier"]["pinned"] == 1
    assert audit_engine(e1).ok  # the pinned carry is clean mid-queue
    e1.run_to_completion()
    assert r.out == r0.out
    cs, sw = e1.health()["state_counters"], e1.health()["swap"]
    assert cs["replay_tokens"] == 0 and cs["state_restores"] == 1
    assert sw["swap_ins"] == sw["verified_swapins"] == 1 and sw["corrupt_swapins"] == 0
    page_bytes = sum(leaf[0].numel() * leaf.element_size()
                     for leaf, ax in zip(tpages.tree_leaves(e1.spool), tpages.tree_leaves(e1.axes))
                     if ax != tpages.REPLICATED)
    assert sw["swap_bytes"] == 2 * page_bytes  # one page out, one in
    # the page the resume restored: fetch vs the reference's, then a round trip
    pid = e1.slots[0].ckpt_page if e1.slots[0].ckpt_page is not None else 1
    src = e1._fetch_page_arrays(pid)
    jspool = jax.tree.map(lambda t: jnp.asarray(t.numpy()), e1.spool)
    ref = jpages.state_page_fetch(jspool, e1.axes, pid)
    assert len(src) == len(ref)
    for a, b in zip(src, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tpages.page_digest(src) == jpages.page_digest(ref)
    tier = tpages.HostPageTier(2)
    entry = tier.take(tier.put(src, tpages.KIND_STATE), expect_kind=tpages.KIND_STATE)
    e1._insert_page_arrays(5, entry)
    for a, b in zip(e1._fetch_page_arrays(5), src):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- forks
def test_forks_greedy_identical_sampled_reproducible():
    prompt = _prompts(1)[0]
    (r0,) = _serve(_engine("none"), tgen, [prompt], max_new=9)
    eng = _engine("none")
    eng.submit(tgen.Request(rid=1, prompt=prompt, max_new=9, n_samples=2))
    fin, _ = eng.run_to_completion()
    assert len(fin) == 2 and all(r.error is None and r.out == r0.out for r in fin)
    assert eng.stats["forks"] == 1 and eng.stats["shared_pages"] == 1
    sp = tgen.SamplingParams(temperature=0.9, top_k=20, seed=7)

    def sampled():
        e = _engine("packed", pipeline_depth=2)
        e.submit(tgen.Request(rid=2, prompt=prompt, max_new=9, n_samples=3, sampling=sp))
        f, _ = e.run_to_completion()
        assert all(x.error is None for x in f)
        return {x.sample_idx: x.out for x in f}

    a, b = sampled(), sampled()
    assert a == b and len({tuple(v) for v in a.values()}) > 1


# ------------------------------------------------------------------ chaos
def test_hot_chaos_contained_and_report_checks(tmp_path):
    """The reference CI's hot state-layout chaos run (seed 3, rate 0.2,
    audit every tick) on the packed smoke: no exception escapes, the
    audit stays clean, and ``tools/check_chaos.py`` accepts the report."""
    from repro_torch.launch.serve import run_chaos

    _, _, tapi, tparams = _models("packed")
    report = tmp_path / "chaos.json"
    rep = run_chaos(tapi, tparams, _prompts(4), 8, page_size=PS, seed=3, rate=0.2,
                    report_path=str(report), audit_every=1, arch=TCFG.name, pipeline_depth=2)
    assert rep["unhandled_exception"] is None and rep["final_audit"]["ok"]
    assert rep["page_layout"] == "state" and rep["leaked_pages"] == 0
    assert rep["faults"]["total"] > 0 and rep["health"]["counters"]["audit_failures"] == 0
    check = subprocess.run([sys.executable, str(ROOT / "tools" / "check_chaos.py"), str(report)],
                           capture_output=True, text=True)
    assert check.returncode == 0, check.stdout + check.stderr


# -------------------------------------------------------------------- CLI
def test_cli_contiguous_paged_host_tier_and_chaos(tmp_path, capsys):
    from repro_torch.launch.serve import main

    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--packed", "--batch", "2",
            "--prompt-len", "10", "--gen", "4", "--page-size", "8"]
    main(base)
    assert "contiguous: 8 tokens" in capsys.readouterr().out
    main(base + ["--paged", "--host-tier"])
    out = capsys.readouterr().out
    assert "8 tokens" in out and "(state pages)" in out and "state_checkpoints 2" in out
    report = tmp_path / "chaos.json"
    assert main(base + ["--chaos", "--chaos-report", str(report)]) == 0
    rep = json.loads(report.read_text())
    assert rep["page_layout"] == "state" and rep["pages_by_kind"]["kv"] == 0
    check = subprocess.run([sys.executable, str(ROOT / "tools" / "check_chaos.py"), str(report)],
                           capture_output=True, text=True)
    assert check.returncode == 0, check.stdout + check.stderr


# ---------------------------------------------------------- state tree ops
def _same_leaves(t_tree, j_tree, what=""):
    tl, jl = tpages.tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)


def test_state_batch_axes_and_tree_ops_match_reference():
    """The hybrid tree's batch axes equal the reference's — ``k_sx`` /
    ``v_sx`` (P,) ``REPLICATED`` — and the state-page ops over it (pool
    init, checkpoint with duplicate null-page rows, restore, extract,
    insert, copy, fetch and digest) equal the reference's bit for bit."""
    cfg5 = dataclasses.replace(CFG, n_layers=5)
    tcfg5 = dataclasses.replace(TCFG, n_layers=5)
    jrt, trt = _rts("none")
    axes = tpages.state_batch_axes(lambda b: thyb.hybrid_cache_init(tcfg5, trt, b, "meta"))
    jaxes = jpages.state_batch_axes(lambda b: jhyb.hybrid_cache_init(cfg5, jrt, b))
    assert tpages.tree_leaves(axes) == jax.tree.leaves(jaxes)
    ring = axes["periods"]["b2"]
    assert ring["k_sx"] == ring["v_sx"] == tpages.REPLICATED
    assert ring["k_idx"] == ring["pos_buf"] == axes["periods"]["b0"]["lru_state"] == 1
    assert axes["tail0"]["conv_state"] == 0

    rng = np.random.default_rng(9)

    def rand(tree):
        return jax.tree.map(lambda a: np.asarray(
            rng.integers(-5, 100, a.shape) if a.dtype in (jnp.int32, jnp.uint8)
            else rng.normal(size=a.shape)).astype(a.dtype), tree)

    live_np = rand(jhyb.hybrid_cache_init(cfg5, jrt, 4))
    jlive = jax.tree.map(jnp.asarray, live_np)
    tlive = from_numpy_tree(live_np)
    jpool = jpages.state_pool_init(lambda b: jhyb.hybrid_cache_init(cfg5, jrt, b), jaxes, 5)
    tpool = tpages.state_pool_init(lambda b: thyb.hybrid_cache_init(tcfg5, trt, b), axes, 5)
    _same_leaves(tpool, jpool, what="pool init")
    assert tpool["periods"]["b2"]["k_sx"].shape == (1,)
    dsts = np.array([3, 0, 0, 2], np.int32)
    # the reference's ops jitted, as its engine runs them (one compile each)
    jpool = jax.jit(lambda p, lv, d: jpages.state_checkpoint_rows(p, lv, jaxes, d))(
        jpool, jlive, jnp.asarray(dsts))
    tpages.state_checkpoint_rows(tpool, tlive, axes, torch.from_numpy(dsts))
    _same_leaves(tpool, jpool, what="checkpoint")
    jlive = jax.jit(lambda lv, p: jpages.state_restore_row(lv, p, jaxes, 1, 3))(jlive, jpool)
    tpages.state_restore_row(tlive, tpool, axes, 1, 3)
    _same_leaves(tlive, jlive, what="restore")
    one = tpages.state_extract_row(tlive, axes, 2)
    _same_leaves(one, jax.jit(lambda lv: jpages.state_extract_row(lv, jaxes, 2))(jlive),
                 what="extract")
    jlive = jax.jit(lambda lv, o: jpages.state_copy_row(
        jpages.state_insert_row(lv, o, jaxes, 0), jaxes, 0, 3))(
        jlive, jax.tree.map(lambda a: jnp.asarray(a.numpy()), one))
    tpages.state_insert_row(tlive, one, axes, 0)
    tpages.state_copy_row(tlive, axes, 0, 3)
    _same_leaves(tlive, jlive, what="insert, copy")
    src, ref = tpages.state_page_fetch(tpool, axes, 3), jpages.state_page_fetch(jpool, axes, 3)
    assert len(src) == len(ref) == len(tpages.tree_leaves(axes)) - 2  # the two s_X stay
    assert tpages.page_digest(src) == jpages.page_digest(ref)
