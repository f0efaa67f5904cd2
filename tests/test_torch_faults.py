"""Fault containment of the port: ``repro_torch.serving.faults`` /
``audit`` and ``PagedEngine``'s lifecycle guard, quarantine, audits and
degradation, against ``repro.serving`` (``tests/test_faults.py``,
``tests/test_pipelined_engine.py``).

* The injector decides byte-equal to the reference's over a grid of
  seeds × sites × ticks × keys.
* Every class of ``tests/test_faults.py`` runs again on the port over a
  torch stub of ``tests/serving_stub.py``'s closed form —
  ``next(tok) = (tok·7 + 3) % 32``, one-hot·10 logits, a NaN row where
  the consumed token is ``nan_token`` — defined here, since that stub
  imports JAX.
* At depth 1 the port and the JAX engine run the same requests under the
  same pinned schedules (alloc, prefix_claim, launch, logits, sampler)
  and seeded chaos scripts: equal finished sets (rid, sample_idx, error
  kind, tokens), ``health()`` counters, engine counters and fault logs —
  on the stub, and on the smoke gpt3_126m with W4A4 packed weights and a
  bcq4 pool.
* The port's depth 2 equals its depth 1 under the same faults (bit for
  bit on the smoke model: tokens, margins, launch ids, error kinds,
  counters, pool bytes); a real NaN is quarantined one tick late but not
  dropped; the deadline anchor survives preemption; deadlines read a
  monotonic clock the test controls.
* ``python -m repro_torch.launch.serve --chaos`` on the CPU writes a
  report that the unchanged ``tools/check_chaos.py`` accepts.

Every port engine built here ends its test drained with a clean audit
(the file's own leak check: ``tests/conftest.py``'s covers the JAX
engine only).
"""
import json
import os
import random
import subprocess
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.serving import engine as tengine
from repro_torch.serving import generate as tgen
from repro_torch.serving.audit import AuditError, audit_engine
from repro_torch.serving.engine import ENGINE_STAT_KEYS, NonFiniteLogitsError, PagedEngine
from repro_torch.serving.faults import SITES, FaultInjector, InjectedFault
from repro_torch.serving.generate import Request
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 32
COUNTERS = tuple(k for k in ENGINE_STAT_KEYS if not k.startswith("t_"))
KINDS = {"cancelled", "expired", "shed", "quarantined"}


# ------------------------------------------------------------ torch stub
def next_token(tok: int) -> int:
    return (tok * 7 + 3) % VOCAB


def expected_greedy(prompt, max_new: int) -> list:
    """The stub's exact greedy output: the prefill's token, then max_new."""
    out, t = [], int(prompt[-1])
    for _ in range(max_new + 1):
        t = next_token(t)
        out.append(t)
    return out


def make_stub_api(nan_token=None):
    """The model-free ModelAPI of ``tests/serving_stub.py`` in torch: logits
    a function of the consumed token only, pool leaves shaped like a
    stacked cache so that the page moves run."""

    def logits_of(tok):
        lg = torch.nn.functional.one_hot((tok.long() * 7 + 3) % VOCAB, VOCAB).float() * 10.0
        if nan_token is not None:
            lg = torch.where((tok == nan_token)[..., None], torch.full_like(lg, float("nan")), lg)
        return lg

    def prefill_fn(params, batch, max_len):
        t = batch["tokens"]
        padded = torch.zeros((t.shape[0], max_len))
        padded[:, : t.shape[1]] = t.float()
        return logits_of(t), {"k": padded[None, :, :][:, :1, :]}

    def prefill_from_pages_fn(params, tok, pool, bt, n_past, ids, chunk_len=None):
        last = tok.gather(1, (chunk_len - 1).clamp(min=0).long()[:, None])
        return logits_of(last), pool

    return SimpleNamespace(
        device=torch.device("cpu"), rt=SimpleNamespace(paged_kernel=False, fused_linear=False),
        trace_counts={"prefill": 0, "decode": 0, "chunk": 0}, prefill_fn=prefill_fn,
        paged_decode_fn=lambda params, pool, tok, bt, lengths: (logits_of(tok[:, 0])[:, None], pool),
        pool_init=lambda n_pages, ps: {"k": torch.zeros((1, n_pages, ps))},
        prefill_from_pages_fn=prefill_from_pages_fn)


STUB = make_stub_api()


def _mk_engine(faults=None, api=STUB, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("n_pages", 24)
    kw.setdefault("chunked_prefill", True)
    kw.setdefault("prefill_chunk", 16)
    return PagedEngine(api, {}, fault_injector=faults, device="cpu", **kw)


def _req(rid, plen, max_new=3, **kw):
    prompt = ((np.arange(plen) + rid) % VOCAB).astype(np.int64)
    return Request(rid=rid, prompt=prompt, max_new=max_new, **kw)


def _no_referenced_pages(eng):
    return int((eng.pool_mgr.refcount > 0).sum()) == 0


def _counters(eng):
    return eng.health()["counters"]


@pytest.fixture(autouse=True)
def _port_leak_check(request, monkeypatch):
    """Every port engine built in a test ends it drained, with a clean
    audit (``no_leak_check`` opts out, for tests that corrupt the state)."""
    engines = []
    init = PagedEngine.__init__

    def tracking(self, *a, **kw):
        init(self, *a, **kw)
        engines.append(self)

    monkeypatch.setattr(PagedEngine, "__init__", tracking)
    yield
    if request.node.get_closest_marker("no_leak_check"):
        return
    for eng in engines:
        assert not eng._inflight and not eng._retiring, "a launch left in flight"
        report = audit_engine(eng)
        assert report.ok, report.violations


# --------------------------------------------------------------- reference
@pytest.fixture(scope="module")
def ref():
    """The reference side: its engine, injector and the JAX stub (one per
    ``nan_token``, so that the engine's jitted steps are shared)."""
    pytest.importorskip("jax")
    import serving_stub

    from repro.serving import faults
    from repro.serving import generate
    from repro.serving.engine import PagedEngine as Engine

    stubs = {}

    def stub(nan_token=None):
        if nan_token not in stubs:
            stubs[nan_token] = serving_stub.make_stub_api(nan_token=nan_token)
        return stubs[nan_token]

    return SimpleNamespace(Engine=Engine, faults=faults, gen=generate, stub=stub)


# ---------------------------------------------------------------- injector
GRID_SEEDS = (0, 1, 7, 2**31 - 1)
GRID_TICKS = (0, 1, 2, 5, 17, 100, 4096)
GRID_KEYS = (0, 1, 3, 31, 2**20)


@pytest.mark.parametrize("seed", GRID_SEEDS)
def test_injector_decides_byte_equal_to_reference(ref, seed):
    """The hash roll, every site's decision at a partial rate and under a
    schedule, the alloc ordinals, the cap and the summary: equal to the
    reference's, query by query, over seeds × sites × ticks × keys."""
    rates = {s: 0.3 for s in SITES}
    sched = [(5, "logits"), (17, "sampler", 3), (2, "alloc", 1)]
    ours = FaultInjector(seed=seed, rates=rates, schedule=sched, max_faults=60)
    theirs = ref.faults.FaultInjector(seed=seed, rates=rates, schedule=sched, max_faults=60)
    for site in SITES:
        for tick in GRID_TICKS:
            for key in GRID_KEYS:
                assert ours._roll(site, tick, key) == theirs._roll(site, tick, key)
                assert ours.fire(site, tick, key) == theirs.fire(site, tick, key)
    for tick in GRID_TICKS:
        assert ours.alloc_fails(tick) == theirs.alloc_fails(tick)
    assert [tuple(vars(e).values()) for e in ours.log] == \
        [tuple(vars(e).values()) for e in theirs.log]
    assert ours.summary() == theirs.summary() and len(ours.log) == 60  # the cap bit


def test_injector_random_queries_equal_reference(ref):
    """Hypothesis-drawn (seed, site, tick, key, rate) queries, derandomized."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(derandomize=True, max_examples=20, deadline=None)
    @hyp.given(st.integers(0, 2**32), st.sampled_from(SITES), st.integers(0, 10**6),
               st.integers(0, 10**6), st.floats(0.0, 1.0))
    def check(seed, site, tick, key, rate):
        a = FaultInjector(seed=seed, rates={site: rate})
        b = ref.faults.FaultInjector(seed=seed, rates={site: rate})
        assert a.fire(site, tick, key) == b.fire(site, tick, key)
        assert a._roll(site, tick, key) == b._roll(site, tick, key)

    check()


class TestFaultInjector:
    def test_decisions_are_pure_functions_of_seed_site_tick_key(self):
        a, b = FaultInjector(seed=7, rates={"alloc": 0.5}), FaultInjector(seed=7, rates={"alloc": 0.5})
        probes = [(t, k) for t in range(20) for k in range(3)]
        got_a = [a.fire("alloc", t, k) for t, k in probes]
        for t, k in reversed(probes):  # another order, other sites between
            b.fire("logits", t, k)
        got_b = [b.fire("alloc", t, k) for t, k in reversed(probes)]
        assert got_a == list(reversed(got_b))
        assert any(got_a) and not all(got_a)

    def test_seed_changes_the_pattern(self):
        rolls = {seed: [FaultInjector(seed=seed, rates={"logits": 0.5}).fire("logits", t, 0)
                        for t in range(32)] for seed in (0, 1)}
        assert rolls[0] != rolls[1]

    def test_rate_extremes(self):
        never = FaultInjector(seed=3, rates={"sampler": 0.0})
        always = FaultInjector(seed=3, rates={"sampler": 1.0})
        assert not any(never.fire("sampler", t, 0) for t in range(50))
        assert all(always.fire("sampler", t, 0) for t in range(50))

    def test_schedule_fires_exactly_where_pinned(self):
        fi = FaultInjector(seed=0, schedule=[(3, "logits"), (5, "logits", 2)])
        assert fi.fire("logits", 3, 0) and fi.fire("logits", 3, 9)
        assert fi.fire("logits", 5, 2)
        assert not fi.fire("logits", 5, 3)
        assert not fi.fire("logits", 4, 0)

    def test_max_faults_bounds_the_run(self):
        fi = FaultInjector(seed=0, rates={"alloc": 1.0}, max_faults=4)
        assert sum(fi.alloc_fails(tick=1) for _ in range(20)) == 4 and len(fi.log) == 4

    def test_alloc_flakes_are_transient_by_ordinal(self):
        fi = FaultInjector(seed=0, schedule=[(1, "alloc", 1)])
        assert fi.alloc_fails(tick=1)
        assert not fi.alloc_fails(tick=1)
        assert not fi.alloc_fails(tick=2)

    def test_sampler_site_raises_injected_fault(self):
        fi = FaultInjector(seed=0, schedule=[(2, "sampler")])
        fi.sampler_raises(tick=1, slot=0)
        with pytest.raises(InjectedFault):
            fi.sampler_raises(tick=2, slot=0)

    def test_unknown_site_rejected(self):
        with pytest.raises(AssertionError):
            FaultInjector(rates={"gpu_on_fire": 1.0})
        with pytest.raises(AssertionError):
            FaultInjector().fire("gpu_on_fire", 1, 0)

    def test_summary_is_jsonable_and_counts_by_site(self):
        fi = FaultInjector(seed=0, schedule=[(1, "alloc"), (1, "logits")])
        fi.alloc_fails(1)
        fi.poison_logits(1, 0)
        s = json.loads(json.dumps(fi.summary()))
        assert s["total"] == 2 and s["by_site"] == {"alloc": 1, "logits": 1}
        assert set(fi.counts()) <= set(SITES)


# ------------------------------------------------------------------- audit
@pytest.mark.no_leak_check  # corrupts the ownership state on purpose
class TestAuditDetection:
    def _busy_engine(self):
        eng = _mk_engine()
        eng.submit(_req(0, plen=10, max_new=4))
        eng.step()
        assert eng._active()
        return eng

    def test_clean_engine_audits_ok(self):
        eng = self._busy_engine()
        report = eng.audit()
        assert report.ok and report.violations == []
        assert report.pages_checked == eng.pool_mgr.n_pages - 1
        report.raise_if_dirty()

    def test_detects_leaked_refcount(self):
        eng = self._busy_engine()
        eng.pool_mgr.alloc()  # a page no block table reaches
        report = eng.audit()
        assert not report.ok
        assert any("block-table references" in v for v in report.violations)
        with pytest.raises(AuditError):
            report.raise_if_dirty()

    def test_detects_dangling_table_reference(self):
        eng = self._busy_engine()
        i = next(i for i, s in enumerate(eng.slots) if s.req is not None)
        pid = int(next(p for p in eng.tables[i] if p != 0))
        eng.pool_mgr.refcount[pid] = 0
        eng.pool_mgr.free.append(pid)
        report = eng.audit()
        assert not report.ok and any("FREED" in v for v in report.violations)

    def test_strict_audit_raises_and_counts(self):
        eng = self._busy_engine()
        eng.pool_mgr.alloc()
        before = _counters(eng)["audit_failures"]
        with pytest.raises(AuditError):
            eng.audit(strict=True)
        assert _counters(eng)["audit_failures"] == before + 1
        assert eng._last_audit is not None and not eng._last_audit.ok

    def test_audit_every_rides_step(self):
        eng = _mk_engine(audit_every=1)
        eng.submit(_req(0, plen=5, max_new=2))
        eng.step()
        assert eng._last_audit is not None and eng._last_audit.ok


# -------------------------------------------------------------- quarantine
class TestQuarantine:
    def test_real_nan_logits_quarantine_only_the_poisoned_request(self):
        # prompt [4] emits 31 at prefill end; the decode tick that consumes
        # 31 reads NaN: a real non-finite forward
        eng = _mk_engine(api=make_stub_api(nan_token=31))
        bad = Request(rid=0, prompt=np.array([4]), max_new=4)
        good = Request(rid=1, prompt=np.array([0]), max_new=4)
        eng.submit(bad)
        eng.submit(good)
        finished, _ = eng.run_to_completion(max_ticks=60)
        by_rid = {r.rid: r for r in finished}
        assert by_rid[0].error.kind == "quarantined"
        assert "NonFiniteLogitsError" in str(by_rid[0].error)
        assert by_rid[1].error is None and by_rid[1].out == expected_greedy(good.prompt, 4)
        assert _counters(eng)["quarantined"] == 1
        assert _no_referenced_pages(eng)

    def test_nan_guard_off_restores_legacy_path(self):
        eng = _mk_engine(api=make_stub_api(nan_token=31), n_slots=2, nan_guard=False)
        eng.submit(Request(rid=0, prompt=np.array([4]), max_new=3))
        finished, _ = eng.run_to_completion(max_ticks=60)
        assert finished[0].error is None
        assert _counters(eng)["quarantined"] == 0

    def test_strict_reraises_nan(self):
        eng = _mk_engine(api=make_stub_api(nan_token=31), n_slots=2, strict=True)
        eng.submit(Request(rid=0, prompt=np.array([4]), max_new=4))
        with pytest.raises(NonFiniteLogitsError):
            eng.run_to_completion(max_ticks=60)
        eng.drain()
        eng._free_slot(0)  # what the raise left behind, so the leak check holds

    def test_injected_logits_poison_at_the_fetch_seam(self):
        faults = FaultInjector(seed=0, schedule=[(3, "logits")])
        eng = _mk_engine(faults)
        eng.submit(_req(0, plen=3, max_new=6))
        finished, _ = eng.run_to_completion(max_ticks=60)
        assert finished[0].error.kind == "quarantined"
        assert faults.counts().get("logits", 0) >= 1
        assert _no_referenced_pages(eng)

    def test_sampler_fault_kills_one_slot_not_the_batch(self):
        faults = FaultInjector(seed=0, schedule=[(3, "sampler", 0)])
        eng = _mk_engine(faults)
        a, b = _req(0, plen=3, max_new=5), _req(1, plen=4, max_new=5)
        eng.submit(a)
        eng.submit(b)
        finished, _ = eng.run_to_completion(max_ticks=60)
        by_rid = {r.rid: r for r in finished}
        dead = [r for r in finished if r.error is not None]
        assert len(dead) == 1 and dead[0].error.kind == "quarantined"
        assert "InjectedFault" in str(dead[0].error)
        alive = by_rid[1 - dead[0].rid]
        assert alive.error is None
        assert alive.out == expected_greedy((a if alive.rid == 0 else b).prompt, 5)
        assert _no_referenced_pages(eng)


# --------------------------------------------------------------- lifecycle
class TestLifecycle:
    def test_deadline_expired_while_queued(self):
        eng = _mk_engine()
        eng.submit(_req(0, plen=4, deadline_s=0.0))
        finished, _ = eng.run_to_completion(max_ticks=10)
        assert finished[0].error.kind == "expired"
        assert _counters(eng)["expired"] == 1
        assert _no_referenced_pages(eng)

    def test_deadline_expired_mid_decode_releases_pages(self):
        eng = _mk_engine()
        req = _req(0, plen=10, max_new=30, deadline_s=60.0)
        eng.submit(req)
        eng.step()
        eng.step()
        assert eng._active() and not req.done
        assert int((eng.pool_mgr.refcount > 0).sum()) > 0
        req.deadline_s = 1e-9  # already over at the next sweep
        eng.step()
        assert req.done and req.error.kind == "expired"
        assert _no_referenced_pages(eng)
        assert eng.audit().ok

    def test_output_stall_ticks_expire_a_starved_request(self):
        # 3 usable pages, watermark 2: never admitted, stalls in the queue
        eng = _mk_engine(n_pages=4, watermark=2, n_slots=2)
        eng.submit(_req(0, plen=9, max_new=2, max_output_stall_ticks=3))
        for _ in range(6):
            eng.step()
        assert eng.finished[0].error.kind == "expired"
        assert "max_output_stall_ticks" in str(eng.finished[0].error)

    def test_cancel_queued_and_decoding(self):
        eng = _mk_engine()
        active, queued = _req(0, plen=6, max_new=20), _req(1, plen=6, max_new=20)
        eng.submit(active)
        eng.step()
        eng.submit(queued)
        active.cancel()
        queued.cancel()
        finished, _ = eng.run_to_completion(max_ticks=30)
        assert {r.error.kind for r in finished} == {"cancelled"}
        assert _counters(eng)["cancelled"] == 2
        assert _no_referenced_pages(eng)

    def test_cancel_before_submit_rejected_at_the_door(self):
        eng = _mk_engine()
        req = _req(0, plen=4)
        req.cancel()
        eng.submit(req)
        assert req.done and req.error.kind == "cancelled"

    def test_cancel_lands_across_a_preemption_resume(self):
        # every allocation of tick 1 fails: the prefilling slot preempts
        # itself and is requeued as a new Request; the cancel on the
        # submitted handle follows the chain
        faults = FaultInjector(seed=0, schedule=[(1, "alloc")])
        eng = _mk_engine(faults, n_slots=2)
        req = _req(0, plen=12, max_new=4)
        eng.submit(req)
        eng.step()
        assert eng.stats["preemptions"] >= 1 and req._resumed_as is not None
        req.cancel()
        finished, _ = eng.run_to_completion(max_ticks=30)
        assert finished[0].rid == 0 and finished[0].error.kind == "cancelled"
        assert _no_referenced_pages(eng)


# ------------------------------------------------------------- degradation
class TestDegradation:
    def test_bounded_queue_sheds_least_slack_first(self):
        eng = _mk_engine(n_slots=1, max_queue=1)
        eng.submit(_req(0, plen=4, max_new=30))
        eng.step()
        hopeless = _req(1, plen=4, deadline_s=0.001)
        eng.submit(hopeless)
        newcomer = _req(2, plen=4)  # no deadline: infinite slack
        eng.submit(newcomer)
        assert hopeless.done and hopeless.error.kind == "shed"
        assert not newcomer.done and list(eng.queue) == [newcomer]
        assert _counters(eng)["shed"] == 1

    def test_shed_finds_its_victim_by_identity(self):
        """Two queued requests with one rid (a resubmission) and a full
        queue: the hopeless one is shed, not compared by value."""
        eng = _mk_engine(n_slots=1, max_queue=2)
        eng.submit(_req(0, plen=4, max_new=30))
        eng.step()
        keep, hopeless = _req(1, plen=6), _req(1, plen=6, deadline_s=0.001)
        eng.submit(keep)
        eng.submit(hopeless)
        eng.submit(_req(2, plen=4))
        assert hopeless.error.kind == "shed" and not keep.done
        assert [r.rid for r in eng.queue] == [1, 2] and eng.queue[0] is keep

    def test_bounded_queue_tie_sheds_the_newcomer(self):
        eng = _mk_engine(n_slots=1, max_queue=1)
        eng.submit(_req(0, plen=4, max_new=30))
        eng.step()
        first, late = _req(1, plen=4), _req(2, plen=4)
        eng.submit(first)
        eng.submit(late)
        assert late.done and late.error.kind == "shed"
        assert list(eng.queue) == [first]

    def test_degraded_mode_hysteresis_and_fork_rejection(self):
        eng = _mk_engine(degrade_after=2, recover_after=2)
        real_wm = eng.watermark
        eng.watermark = eng.pool_mgr.n_pages  # sustained pressure
        eng.step()
        assert not eng.degraded
        eng.step()
        assert eng.degraded and eng.health()["status"] == "degraded"
        fork = _req(0, plen=4, n_samples=2)
        eng.submit(fork)
        assert fork.done and fork.error.kind == "shed" and "degraded" in str(fork.error)
        plain = _req(1, plen=4, max_new=2)
        eng.submit(plain)
        assert not plain.done
        eng.watermark = real_wm
        eng.step()
        assert eng.degraded
        eng.step()
        assert not eng.degraded
        assert _counters(eng)["degraded_ticks"] >= 2
        eng.run_to_completion(max_ticks=30)
        assert plain.done and plain.error is None

    def test_degraded_mode_shrinks_parked_prefix_pages(self):
        eng = _mk_engine(degrade_after=1, recover_after=4, degraded_prefix_target=0)
        eng.submit(_req(0, plen=16, max_new=1))
        eng.run_to_completion(max_ticks=30)
        assert eng.prefix.reclaimable_count() > 0
        evicted = eng.stats["prefix_evictions"]
        eng.watermark = eng.pool_mgr.n_pages
        eng.step()
        assert eng.degraded and eng.prefix.reclaimable_count() == 0
        assert eng.stats["prefix_evictions"] > evicted

    def test_health_shape(self, ref):
        eng = _mk_engine()
        h = eng.health()
        assert h["status"] == "ok" and h["degraded"] is False
        theirs = ref.Engine(ref.stub(), {}, n_slots=4, max_len=64, page_size=8, n_pages=24,
                            chunked_prefill=True, prefill_chunk=16).health()
        assert h.keys() == theirs.keys()
        assert h["counters"] == theirs["counters"] == dict.fromkeys(KINDS | {
            "audit_failures", "degraded_ticks"}, 0)
        assert h["swap"] == theirs["swap"] and h["host_tier"] is theirs["host_tier"] is None

    def test_stuck_head_of_line_is_shed_by_default(self):
        """A request the pool can never admit is shed after two stuck ticks
        and the rest is served (``shed_stuck=False`` raises instead,
        tests/test_torch_engine.py)."""
        eng = _mk_engine(n_pages=4, n_slots=2)  # 3 pages < a 20-token prompt + watermark
        big, small = _req(0, plen=20, max_new=2), _req(1, plen=3, max_new=2)
        eng.submit(big)
        eng.submit(small)
        finished, _ = eng.run_to_completion(max_ticks=30)
        by_rid = {r.rid: r for r in finished}
        assert by_rid[0].error.kind == "shed" and "pool too small" in str(by_rid[0].error)
        assert by_rid[1].error is None and by_rid[1].out == expected_greedy(small.prompt, 2)
        assert _counters(eng)["shed"] == 1


# ------------------------------------------- transient-fault transparency
class TestTransientTransparency:
    def test_admission_retries_through_alloc_flakes_output_exact(self):
        faults = FaultInjector(seed=0, schedule=[(1, "alloc")])
        eng = _mk_engine(faults, chunked_prefill=False)
        req = _req(0, plen=9, max_new=4)
        eng.submit(req)
        finished, _ = eng.run_to_completion(max_ticks=30)
        assert faults.counts().get("alloc", 0) >= 1
        assert finished[0].error is None and finished[0].out == expected_greedy(req.prompt, 4)
        assert req._admit_retries >= 1
        assert _no_referenced_pages(eng)

    def test_chunk_tick_flakes_preempt_and_resume_exact(self):
        faults = FaultInjector(seed=0, schedule=[(2, "alloc")])
        eng = _mk_engine(faults, prefill_chunk=8)
        req = _req(0, plen=20, max_new=4)
        eng.submit(req)
        finished, _ = eng.run_to_completion(max_ticks=40)
        assert finished[0].error is None and finished[0].out == expected_greedy(req.prompt, 4)
        assert _no_referenced_pages(eng)

    def test_dropped_prefix_claims_force_exact_recompute(self):
        faults = FaultInjector(seed=0)
        eng = _mk_engine(faults)
        eng.submit(_req(0, plen=16, max_new=1))
        eng.run_to_completion(max_ticks=30)
        assert eng.prefix.reclaimable_count() > 0
        faults.schedule.add((eng._tick + 1, "prefix_claim"))
        hits = eng.stats["prefix_hits"]
        again = _req(0, plen=16, max_new=1)
        eng.submit(again)
        eng.run_to_completion(max_ticks=30)
        assert again.error is None and again.out == expected_greedy(again.prompt, 1)
        assert eng.stats["prefix_hits"] == hits
        assert faults.counts().get("prefix_claim", 0) >= 1

    def test_stuck_shed_waits_out_a_transient_flake(self):
        faults = FaultInjector(seed=0, schedule=[(1, "alloc")])
        eng = _mk_engine(faults, n_slots=1)
        req = _req(0, plen=12, max_new=2)
        eng.submit(req)
        finished, _ = eng.run_to_completion(max_ticks=30)
        assert finished[0].error is None and finished[0].out == expected_greedy(req.prompt, 2)
        assert _counters(eng)["shed"] == 0


# ------------------------------------------------------------- chaos loop
def _chaos_ops(seed, n_ops=60):
    """A seeded script of submits, ticks, scheduled faults and cancels (the
    scenario of tests/test_faults.py's chaos loop)."""
    rng = random.Random(seed)
    ops, rid = [], 0
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.35:
            plen, base = rng.randint(1, 20), rng.randint(0, VOCAB - 1)
            ops.append(("submit", dict(
                rid=rid, prompt=((np.arange(plen) + base) % VOCAB).astype(np.int64),
                max_new=rng.randint(1, 5), n_samples=rng.choice([1, 1, 1, 2]),
                deadline_s=rng.choice([None, None, None, 0.0]))))
            rid += 1
        elif op < 0.75:
            ops.append(("step",))
        elif op < 0.95:
            ops.append(("fault", rng.choice(["alloc", "prefix_claim", "logits", "sampler"])))
        else:
            ops.append(("cancel", rng.random()))
    return ops


def _play(eng, faults, ops, request_cls, audit=None):
    """Run ``ops`` on ``eng``; ``audit`` (if given) after every op.  Returns
    the submitted requests."""
    submitted = []
    for op in ops:
        if op[0] == "submit":
            req = request_cls(**op[1])
            submitted.append(req)
            eng.submit(req)
        elif op[0] == "step":
            eng.step()
        elif op[0] == "fault":
            faults.schedule.add((eng._tick + 1, op[1]))
        else:
            live = [r for r in submitted if not r.done]
            if live:
                live[int(op[1] * len(live))].cancel()
        if audit is not None:
            report = audit(eng)
            assert report.ok, report.violations
    return submitted


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_chaos_run_contains_every_fault(seed):
    """After every op the audit is clean; at the end the engine drains,
    references no page, every request finished, healthy greedy outputs
    equal the closed form and every error is typed."""
    faults = FaultInjector(seed=seed)
    eng = _mk_engine(faults)
    submitted = _play(eng, faults, _chaos_ops(seed), Request, audit_engine)
    reference = {r.rid: expected_greedy(r.prompt, r.max_new) for r in submitted}
    finished, ticks = eng.run_to_completion(max_ticks=400)
    assert ticks < 400 and not eng.queue and not eng._active()
    assert audit_engine(eng).ok and _no_referenced_pages(eng)
    assert set(reference) <= {r.rid for r in finished}
    for fin in finished:
        assert fin.done
        if fin.error is None:
            assert fin.out == reference[fin.rid], f"seed {seed} rid {fin.rid}"
        else:
            assert fin.error.kind in KINDS, repr(fin.error)


# ------------------------------------------------- the port vs the reference
def _outcome(eng):
    """(rid, sample_idx) → (error kind, tokens), the health counters, the
    engine counters and the fault log of one run."""
    fin = {(r.rid, r.sample_idx): (None if r.error is None else r.error.kind, list(r.out))
           for r in eng.finished}
    log = [(e.tick, e.site, e.key) for e in eng.faults.log] if eng.faults is not None else []
    return fin, eng.health()["counters"], {k: eng.stats[k] for k in COUNTERS}, log


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_chaos_script_matches_reference_engine(ref, seed):
    """The seeded chaos script on both engines at depth 1, with rates on
    every non-swap site on top of the script's pinned faults: equal
    finished sets (error kinds, tokens), health and engine counters, and
    fault logs entry by entry."""
    rates = {"alloc": 0.05, "prefix_claim": 0.2, "launch": 0.05, "logits": 0.02, "sampler": 0.02}
    runs = []
    for side in ("port", "ref"):
        if side == "port":
            faults = FaultInjector(seed=seed, rates=rates, delay_s=1e-4)
            eng = _mk_engine(faults)
            cls = Request
        else:
            faults = ref.faults.FaultInjector(seed=seed, rates=rates, delay_s=1e-4)
            eng = ref.Engine(ref.stub(), {}, n_slots=4, max_len=64, page_size=8, n_pages=24,
                             chunked_prefill=True, prefill_chunk=16, fault_injector=faults)
            cls = ref.gen.Request
        _play(eng, faults, _chaos_ops(seed), cls)
        eng.run_to_completion(max_ticks=400)
        runs.append(_outcome(eng))
    assert runs[0] == runs[1] and runs[0][3]


def _stub_specs():
    """Six requests on four slots: shared 16-token prefixes (prefix hits),
    a greedy fork of 2, a sampled request, two with deadline 0.0."""
    base = np.arange(16) % VOCAB
    out = []
    for rid, (tail, max_new) in enumerate(((3, 6), (5, 4), (2, 7), (9, 5), (4, 6), (6, 3))):
        prompt = np.concatenate([base, (np.arange(tail) * 5 + rid) % VOCAB]).astype(np.int64)
        kw = {}
        if rid == 1:
            kw["n_samples"] = 2
        if rid == 3:
            kw["sampling"] = (0.8, 8, 11)
        if rid in (4, 6):
            kw["deadline_s"] = 0.0
        out.append((rid, prompt, max_new, kw))
    out.append((6, np.arange(5).astype(np.int64), 3, {"deadline_s": 0.0}))
    return out


# covers alloc (mid chunk tick), prefix_claim (a hit), launch, logits on a
# decoding slot and sampler on the sampled request's slot
STUB_SCHEDULE = [(1, "alloc", 5), (6, "prefix_claim"), (3, "launch"), (4, "logits", 0),
                 (8, "sampler", 0)]


def _run_specs(eng, mod, specs, cancel=None, max_ticks=200):
    """Submit ``specs`` (rid, prompt, max_new, kw) on ``eng`` (``mod``: its
    generate module); ``cancel`` = (rid, after tick) cancels that request
    between two steps; then run to completion."""
    reqs = []
    for rid, prompt, max_new, kw in specs:
        kw = dict(kw)
        if "sampling" in kw:
            kw["sampling"] = mod.SamplingParams(*kw["sampling"])
        reqs.append(mod.Request(rid=rid, prompt=prompt, max_new=max_new, **kw))
        eng.submit(reqs[-1])
    if cancel is not None:
        while eng._tick < cancel[1]:
            eng.step()
        next(r for r in reqs if r.rid == cancel[0]).cancel()
    eng.run_to_completion(max_ticks=max_ticks)
    return reqs


@pytest.mark.parametrize("nan_token", [None, 31], ids=["seams", "real-nan"])
def test_pinned_schedule_matches_reference_on_stub(ref, nan_token):
    """The pinned schedule (every non-swap site), a cancel mid-decode, two
    requests expired in the queue and (``real-nan``) a real non-finite
    row: equal outcomes, counters and fault logs on both engines."""
    runs = []
    for side in ("port", "ref"):
        if side == "port":
            faults = FaultInjector(seed=0, schedule=STUB_SCHEDULE, delay_s=1e-4)
            eng = _mk_engine(faults, api=make_stub_api(nan_token))
            mod = tgen
        else:
            faults = ref.faults.FaultInjector(seed=0, schedule=STUB_SCHEDULE, delay_s=1e-4)
            eng = ref.Engine(ref.stub(nan_token), {}, n_slots=4, max_len=64, page_size=8,
                             n_pages=24, chunked_prefill=True, prefill_chunk=16,
                             fault_injector=faults)
            mod = ref.gen
        _run_specs(eng, mod, _stub_specs(), cancel=(2, 7))
        runs.append(_outcome(eng))
    assert runs[0] == runs[1]
    fin, counters, stats, log = runs[0]
    assert {site for _, site, _ in log} == {"alloc", "prefix_claim", "launch", "logits", "sampler"}
    assert stats["preemptions"] == 1 and stats["prefix_hits"] > 0 and stats["forks"] == 1
    assert counters["expired"] == 2
    # the logits seam (rid 0), the sampler seam (rid 3), and with a real NaN
    # rid 2, whose row reaches token 31 before the cancel
    assert counters["quarantined"] == (2 if nan_token is None else 3)
    assert counters["cancelled"] == (1 if nan_token is None else 0)


# --------------------------------------------------- depth 2 ≡ depth 1
def _port_run(api, params, specs, depth, faults=None, cancel=None, **kw):
    eng = PagedEngine(api, params, device="cpu", pipeline_depth=depth, fault_injector=faults,
                      **kw)
    _run_specs(eng, tgen, specs, cancel=cancel)
    out = {(r.rid, r.sample_idx): (None if r.error is None else r.error.kind, list(r.out),
                                   list(r.margins), list(r.launch_ids)) for r in eng.finished}
    pool = {n: t.clone() for n, t in eng.pool.items()}
    log = sorted((e.tick, e.site, e.key) for e in faults.log) if faults is not None else []
    return out, eng.health()["counters"], {k: eng.stats[k] for k in COUNTERS}, log, pool


def _same(a, b):
    assert a[:4] == b[:4]
    assert a[4].keys() == b[4].keys() and all(torch.equal(a[4][n], b[4][n]) for n in a[4])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth2_equals_depth1_under_chaos_on_stub(seed):
    """Rate-driven faults on every non-swap site plus the pinned schedule:
    depth 2 demotes the same requests as depth 1 and books the same
    tokens, launch ids, counters and fault decisions."""
    rates = {"alloc": 0.05, "prefix_claim": 0.2, "launch": 0.05, "logits": 0.03, "sampler": 0.03}
    runs = [_port_run(STUB, {}, _stub_specs(), d, cancel=(2, 7),
                      faults=FaultInjector(seed=seed, rates=rates, schedule=STUB_SCHEDULE,
                                           delay_s=1e-4),
                      n_slots=4, max_len=64, page_size=8, n_pages=24, chunked_prefill=True,
                      prefill_chunk=16) for d in (1, 2)]
    _same(runs[0], runs[1])
    assert any(k == "quarantined" for k, *_ in runs[0][0].values())


def test_real_nan_quarantine_is_deferred_not_dropped():
    """A real non-finite forward is found at the sync, a tick after the
    launch at depth 2, and still demotes exactly the poisoned request; the
    others equal the closed form at both depths."""
    api = make_stub_api(nan_token=31)
    specs = [(0, np.array([9]), 4, {}), (1, np.array([4]), 4, {}), (2, np.array([2]), 4, {})]
    runs = [_port_run(api, {}, specs, d, n_slots=4, max_len=64, page_size=8, n_pages=48,
                      chunked_prefill=True, prefill_chunk=16) for d in (1, 2)]
    for out, counters, *_ in runs:
        assert {key for key, v in out.items() if v[0] is not None} == {(1, 0)}
        assert counters["quarantined"] == 1
        assert out[(0, 0)][1] == expected_greedy([9], 4)
        assert out[(2, 0)][1] == expected_greedy([2], 4)
    assert runs[0][0] == runs[1][0]


def test_deadline_anchor_survives_preemption_chain():
    """The monotonic deadline anchor is stamped at the first submit and
    carried through every preemption: a resumed request never gets a fresh
    budget."""
    eng = _mk_engine(n_slots=3, n_pages=8, max_len=48, pipeline_depth=2)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, VOCAB, int(rng.integers(1, 14))), max_new=8,
                    deadline_s=3600.0) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert eng.stats["preemptions"] > 0
    assert all(r.error is None for r in eng.finished)
    for r in reqs:
        seen = r
        while seen is not None:
            assert seen._t_submit == r._t_submit
            seen = seen._resumed_as
    assert any(r._resumed_as is not None for r in reqs)


@pytest.mark.parametrize("depth", [1, 2])
def test_deadline_expires_on_the_monotonic_clock(monkeypatch, depth):
    """``deadline_s`` compares spans of the engine's monotonic clock (a
    clock the test moves here): under the budget the request decodes;
    once the clock passes it, the next tick tears it down, its in-flight
    launch drained first."""
    now = [100.0]
    monkeypatch.setattr(tengine, "time", types.SimpleNamespace(perf_counter=lambda: now[0]))
    eng = _mk_engine(pipeline_depth=depth)
    r = Request(rid=0, prompt=np.array([3]), max_new=50, deadline_s=0.5)
    eng.submit(r)
    for _ in range(4):
        now[0] += 0.1
        eng.step()
    assert not r.done and len(r.out) == 6 - depth  # depth 2: one token still in flight
    now[0] += 0.3
    eng.step()
    assert r.done and r.error.kind == "expired" and "deadline_s=0.5" in str(r.error)
    assert r.out == expected_greedy([3], 50)[:5]  # the in-flight token booked before teardown
    assert _no_referenced_pages(eng)


# ------------------------------------------- smoke gpt3_126m, W4A4, bcq4
PS, CHUNK, SLOTS, MAX_LEN = 8, 16, 4, 32


@pytest.fixture(scope="module")
def w4a4(ref):
    """The smoke gpt3_126m packed to W4 (seeded ``jax.random`` weights): the
    reference's api and tree, the port's api and tree."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_smoke
    from repro.core import ptq
    from repro.core.bcq import BCQConfig
    from repro.core.calibrate import default_universal_codebooks
    from repro.models import zoo
    from repro.models.layers import Runtime
    from repro_torch.configs.base import get_smoke as t_get_smoke
    from repro_torch.models import zoo as tzoo
    from repro_torch.models.convert import from_numpy_tree
    from repro_torch.models.layers import Runtime as TRuntime

    cfg, cb = get_smoke("gpt3_126m"), default_universal_codebooks(BCQConfig()).as_jnp()
    rt = Runtime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32)
    packed = ptq.pack_params(zoo.build(cfg, rt).init(jax.random.PRNGKey(0)), cb, BCQConfig())
    packed["codebooks"] = cb
    jrt = Runtime(quant_mode="packed", compute_dtype=jnp.float32, param_dtype=jnp.float32,
                  cache_kind="bcq4", paged_kernel=False, fused_linear=True)
    trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                   paged_kernel=True, fused_linear=True)
    return SimpleNamespace(
        japi=zoo.build(cfg, jrt), jparams=packed, vocab=cfg.vocab,
        tapi=tzoo.build(t_get_smoke("gpt3_126m"), trt, device="cpu"),
        tparams=from_numpy_tree(jax.tree.map(np.asarray, packed)))


def _w4a4_specs(vocab):
    """Six requests on four slots sharing a 16-token prefix: a greedy fork
    of 2 (rid 1), a sampled request (rid 3), one expired in the queue
    (rid 5); the tests cancel rid 2 mid-decode."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, 2 * PS)
    out = []
    for rid, (tail, max_new) in enumerate(((3, 5), (5, 4), (2, 6), (7, 5), (4, 6), (1, 3))):
        kw = {1: {"n_samples": 2}, 3: {"sampling": (0.8, 40, 1234)}, 5: {"deadline_s": 0.0}}
        out.append((rid, np.concatenate([prefix, rng.integers(0, vocab, tail)]), max_new,
                    kw.get(rid, {})))
    return out


# alloc mid chunk tick (a preemption), prefix_claim on rid 4's hits,
# launch delays, logits on rid 0's decoding slot, sampler on rid 3's
# (sampled) slot
W4A4_SCHEDULE = [(1, "alloc", 2), (6, "prefix_claim"), (2, "launch"), (4, "logits", 0),
                 (8, "sampler", 0)]
W4A4_ENGINE = dict(n_slots=SLOTS, max_len=MAX_LEN, page_size=PS, prefill_chunk=CHUNK,
                   chunked_prefill=True)


def test_pinned_schedule_matches_reference_w4a4(ref, w4a4):
    """Port against the JAX engine at depth 1 on the smoke W4A4/bcq4 model
    under the pinned schedule and a cancel mid-decode: equal finished sets
    (rid, sample_idx, error kind, tokens), health and engine counters and
    fault logs."""
    specs = _w4a4_specs(w4a4.vocab)
    jfaults = ref.faults.FaultInjector(seed=0, schedule=W4A4_SCHEDULE, delay_s=1e-4)
    jeng = ref.Engine(w4a4.japi, w4a4.jparams, pipeline_depth=1, fault_injector=jfaults,
                      **W4A4_ENGINE)
    _run_specs(jeng, ref.gen, specs, cancel=(2, 6))
    tfaults_ = FaultInjector(seed=0, schedule=W4A4_SCHEDULE, delay_s=1e-4)
    teng = PagedEngine(w4a4.tapi, w4a4.tparams, device="cpu", fault_injector=tfaults_,
                       **W4A4_ENGINE)
    _run_specs(teng, tgen, specs, cancel=(2, 6))
    jout, tout = _outcome(jeng), _outcome(teng)
    assert jout == tout  # tokens too: no launch of this workload flips a W4A4 token
    assert {site for _, site, _ in tout[3]} == {"alloc", "prefix_claim", "launch", "logits",
                                                "sampler"}
    assert {v[0] for v in tout[0].values()} >= {None, "quarantined", "expired", "cancelled"}
    assert sum(len(v[1]) for v in tout[0].values()) == 30


def test_depth2_equals_depth1_w4a4(w4a4):
    """The port's depth 2 against its depth 1 on the smoke W4A4/bcq4 model
    under the pinned schedule and the cancel: bit for bit — tokens,
    margins, launch ids, error kinds, health and engine counters, fault
    decisions, pool bytes."""
    specs = _w4a4_specs(w4a4.vocab)
    runs = [_port_run(w4a4.tapi, w4a4.tparams, specs, d, cancel=(2, 6),
                      faults=FaultInjector(seed=0, schedule=W4A4_SCHEDULE, delay_s=1e-4),
                      **W4A4_ENGINE) for d in (1, 2)]
    _same(runs[0], runs[1])
    assert runs[0][1] == dict(quarantined=2, shed=0, expired=1, cancelled=1, audit_failures=0,
                              degraded_ticks=0)


# ------------------------------------------------------------------- CLI
def test_chaos_cli_report_passes_check_chaos(tmp_path):
    """``launch.serve --smoke --chaos`` on the CPU at the CLI's default
    rate: its report passes the unchanged ``tools/check_chaos.py``."""
    report = tmp_path / "chaos.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for cmd in ([sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--chaos",
                 "--device", "cpu", "--batch", "4", "--prompt-len", "20", "--gen", "6",
                 "--page-size", "8", "--chaos-seed", "1", "--chaos-report", str(report)],
                [sys.executable, str(ROOT / "tools" / "check_chaos.py"), str(report)]):
        done = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=120)
        assert done.returncode == 0, done.stdout + done.stderr
    rep = json.loads(report.read_text())
    assert rep["all_finished"] and rep["leaked_pages"] == 0 and rep["final_audit"]["ok"]
    assert rep["faults"]["total"] > 0
