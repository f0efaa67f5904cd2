"""The port's host-RAM page tier (``repro_torch.serving.pages.HostPageTier``,
the KV movers, the recompression ladder and ``PagedEngine``'s swap
seams) against ``repro.serving`` (``tests/test_host_tier.py``).

* Every class of ``tests/test_host_tier.py`` — the tier unit, the bitwise
  KV movers, host prefix hits, preempt → swap → resume, the swap fault
  seams and the recompression ladder — runs each scenario on both sides
  with the same schedule: the port's engine over the torch stub of
  ``tests/test_torch_faults.py`` and the reference's ``PagedEngine`` over
  ``tests/serving_stub.py``.  Each side must pass the reference test's
  assertions, and the two must agree on the finished requests (error
  kinds, tokens), every engine and swap counter, the journal's instant
  names in order and ``health()["host_tier"]``.  The state-layout mover
  (``test_state_page_round_trip_bitwise_with_replicated_leaf``) waits for
  the state engine that uses it (ROADMAP A12).
* ``kv_page_fetch`` arrays and ``page_digest`` bytes equal the
  reference's on bf16, int8 and bcq4 pools built from the same seeded
  bytes (the per-page leaves in sorted-key order, bf16 hashed by the name
  ``"bfloat16"``).
* ``_fake_quant`` and ``kv_page_recompress`` are byte-equal to the
  reference's (f32 and bf16 leaves; random, integer-valued, all-zero
  pages and .5 ties).
* A forked sibling preempted with the tier on resumes from host (the port
  finds the slot by identity; the reference's ``slots.index`` raises).
* Depth 2 equals depth 1 bit for bit with the tier on — tokens, margins,
  launch ids, counters, pool bytes, tier snapshots — on the stub and on
  the smoke gpt3_126m (W4A4 packed, bcq4 pages, chunked), a corrupt
  swap-in among the cases.
* On the smoke gpt3_126m the port and the reference agree on a
  preempt-and-resume workload under the margin rule (``TOL`` 1e-3, as
  tests/test_torch_serving_core.py), with equal swap counters.
* ``cuda``-marked tests (skipped without a card): a graph replay after an
  in-place swap-in reads the restored page; a swap round trip is bitwise
  for all three page kinds; a swap-out at depth 2 sees the writes of the
  launch still in flight.

Tolerances: everything is compared exactly except the smoke model's
port-vs-reference tokens (the margin rule at ``TOL``).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_faults import VOCAB, _port_leak_check, expected_greedy, make_stub_api  # noqa: F401

from repro_torch.serving import generate as tgen
from repro_torch.serving import pages as tpages
from repro_torch.serving.engine import ENGINE_STAT_KEYS, PagedEngine
from repro_torch.serving.faults import FaultInjector
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

STUB = make_stub_api()
COUNTERS = tuple(k for k in ENGINE_STAT_KEYS if not k.startswith("t_"))
TOL = 1e-3
STUB_ENGINE = dict(n_slots=4, max_len=64, page_size=8, n_pages=24, chunked_prefill=True,
                   prefill_chunk=16, host_pages=16)
PORT = SimpleNamespace(name="port", Engine=functools.partial(PagedEngine, device="cpu"),
                       stub=STUB, pages=tpages, FaultInjector=FaultInjector, gen=tgen)


@pytest.fixture(scope="module")
def ref():
    """The reference side: its engine, pages module, injector and the JAX stub."""
    pytest.importorskip("jax")
    import serving_stub

    from repro.serving import faults, generate
    from repro.serving import pages
    from repro.serving.engine import PagedEngine as Engine

    return SimpleNamespace(name="ref", Engine=Engine, stub=serving_stub.make_stub_api(),
                           pages=pages, FaultInjector=faults.FaultInjector, gen=generate)


def _engine(side, faults=None, **kw):
    return side.Engine(side.stub, {}, fault_injector=faults, **{**STUB_ENGINE, **kw})


def _req(side, rid, plen, max_new=3, **kw):
    prompt = ((np.arange(plen) + rid) % VOCAB).astype(np.int64)
    return side.gen.Request(rid=rid, prompt=prompt, max_new=max_new, **kw)


def _swap(eng):
    return {k: c.value for k, c in eng._cs_swap.items()}


def _instants(eng):
    return [rec[1] for rec in eng.telemetry.journal._buf if rec[0] == "instant"]


def _no_referenced_pages(eng):
    return int((eng.pool_mgr.refcount > 0).sum()) == 0


def _outcome(eng):
    """What the two sides must agree on after a scenario."""
    fin = sorted((int(r.rid), r.sample_idx, None if r.error is None else r.error.kind, list(r.out))
                 for r in eng.finished)
    return (fin, {k: eng.stats[k] for k in COUNTERS}, _swap(eng), _instants(eng),
            eng.health()["host_tier"], eng.prefix.host_count())


def _both(ref, scenario):
    """Run ``scenario(side)`` on the port and on the reference; the two
    outcomes (and whatever the scenario returns) must be equal."""
    got = [scenario(side) for side in (PORT, ref)]
    assert got[0] == got[1]
    return got[0]


def _step_until_decoding(eng, req, min_out=2, max_ticks=30):
    """Tick until ``req`` has ``min_out`` tokens, then drain, so that a
    preemption sees a settled slot."""
    for _ in range(max_ticks):
        eng.step()
        if len(req.out) >= min_out:
            break
    eng.drain()
    assert len(req.out) >= min_out
    return len(req.out)


def _np(a):
    """A host array of either side as numpy (bf16 as its uint16 bits)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


# ------------------------------------------------------------- tier unit
class TestHostPageTier:
    def test_put_take_round_trip_and_accounting(self, ref):
        def run(side):
            tier = side.pages.HostPageTier(4)
            a = np.arange(12, dtype=np.float32).reshape(3, 4)
            b = np.arange(6, dtype=np.int32)
            h = tier.put([a, b], "kv", meta={"rid": 7})
            assert h >= side.pages._HANDLE_BASE
            assert tier.used() == 1 and tier.has(h) and tier.kind_of(h) == "kv"
            assert tier.bytes_resident == a.nbytes + b.nbytes
            digest = tier.entries[h].digest
            entry = tier.take(h, expect_kind="kv")
            np.testing.assert_array_equal(_np(entry.arrays[0]), a)
            np.testing.assert_array_equal(_np(entry.arrays[1]), b)
            assert entry.meta["rid"] == 7
            assert not tier.has(h) and tier.used() == 0 and tier.bytes_resident == 0
            return h, digest, tier.snapshot()

        _both(ref, run)

    def test_put_copies_the_payload(self, ref):
        def run(side):
            tier = side.pages.HostPageTier(2)
            a = np.zeros(4, np.float32)
            h = tier.put([a], "kv")
            a[:] = 9.0  # the caller reuses its buffer after the put
            np.testing.assert_array_equal(_np(tier.take(h).arrays[0]), np.zeros(4, np.float32))
            return h

        _both(ref, run)

    def test_corruption_detected_and_entry_consumed(self, ref):
        def run(side):
            tier = side.pages.HostPageTier(2)
            h = tier.put([np.arange(8, dtype=np.float32)], "kv")
            tier.corrupt(h)
            with pytest.raises(side.pages.PageCorruptionError) as ei:
                tier.take(h)
            assert "integrity" in str(ei.value)
            assert not tier.has(h) and tier.used() == 0
            return str(ei.value)

        _both(ref, run)

    def test_kind_mismatch_raises_and_consumes(self, ref):
        def run(side):
            tier = side.pages.HostPageTier(2)
            h = tier.put([np.zeros(4, np.float32)], "state")
            with pytest.raises(side.pages.PageCorruptionError) as ei:
                tier.take(h, expect_kind="kv")
            assert not tier.has(h)
            return str(ei.value)

        _both(ref, run)

    def test_evict_lru_skips_pinned(self, ref):
        def run(side):
            tier = side.pages.HostPageTier(3)
            pinned = tier.put([np.zeros(2, np.float32)], "kv", pinned=True)
            old = tier.put([np.ones(2, np.float32)], "kv")
            new = tier.put([np.full(2, 2.0, np.float32)], "kv")
            ev = tier.evict_lru()
            assert ev is not None and ev[0] == old  # the oldest UNPINNED entry
            assert tier.has(pinned) and tier.has(new)
            tier.pin(pinned, False)
            ev2 = tier.evict_lru()
            assert ev2 is not None and ev2[0] == pinned
            tier.pin(new)
            assert tier.evict_lru() is None  # only pinned entries left
            return ev, ev2, tier.snapshot()

        _both(ref, run)

    def test_capacity_is_a_hard_bound(self, ref):
        def run(side):
            tier = side.pages.HostPageTier(1)
            tier.put([np.zeros(2, np.float32)], "kv")
            assert tier.full()
            with pytest.raises(AssertionError):
                tier.put([np.zeros(2, np.float32)], "kv")
            return tier.snapshot()

        _both(ref, run)

    def test_snapshot_keys(self, ref):
        def run(side):
            tier = side.pages.HostPageTier(2)
            tier.put([np.zeros(2, np.float32)], "kv", pinned=True)
            assert tier.snapshot() == {"used": 1, "capacity": 2, "bytes_resident": 8, "pinned": 1}
            return tier.snapshot()

        _both(ref, run)


# ------------------------------------------------------ bitwise movers
def _pool_bits(kind, n_pages=6, seed=0):
    """Seeded numpy bytes of a (L 2, n_pages, ps 4, H 2, D 8) pool of
    ``kind``, leaves in the port's insertion order: name → (numpy dtype
    name, array of the dtype's bits)."""
    rng = np.random.default_rng(seed)
    shp = (2, n_pages, 4, 2)

    def bits(dt, *tail):
        return rng.integers(0, 256, shp + tail + (np.dtype(dt).itemsize,), dtype=np.uint8) \
            .view(dt)[..., 0]

    if kind == "bf16":
        return {"k": ("bfloat16", bits(np.uint16, 8)), "v": ("bfloat16", bits(np.uint16, 8))}
    if kind == "int8":
        return {"k": ("int8", bits(np.int8, 8)), "v": ("int8", bits(np.int8, 8)),
                "k_scale": ("float32", rng.random(shp).astype(np.float32)),
                "v_scale": ("float32", rng.random(shp).astype(np.float32))}
    out = {}
    for nm in ("k", "v"):
        out[f"{nm}_idx"] = ("uint8", bits(np.uint8, 4))
        out[f"{nm}_sel"] = ("uint8", bits(np.uint8, 1))
        out[f"{nm}_scale"] = ("uint8", bits(np.uint8, 1))
    out["k_sx"] = ("float32", np.full((2,), 0.5, np.float32))
    out["v_sx"] = ("float32", np.full((2,), 0.25, np.float32))
    return out


def _torch_pool(spec):
    return {n: (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                if dt == "bfloat16" else torch.from_numpy(a.copy())) for n, (dt, a) in spec.items()}


def _jax_pool(ref, spec):
    import jax.numpy as jnp
    from jax import lax

    return {n: (lax.bitcast_convert_type(jnp.asarray(a), jnp.bfloat16) if dt == "bfloat16"
                else jnp.asarray(a)) for n, (dt, a) in spec.items()}


class TestPageMoversBitwise:
    def test_kv_page_round_trip_bitwise_across_dtypes(self, ref):
        rng = np.random.default_rng(0)
        f32 = rng.normal(size=(2, 6, 4)).astype(np.float32)
        bf = rng.normal(size=(2, 6, 4)).astype(np.float32)
        pool = {"f32": torch.from_numpy(f32.copy()), "bf16": torch.from_numpy(bf).bfloat16()}
        src = tpages.kv_page_fetch(pool, 3)
        want = [a.clone() for a in src]
        tier = tpages.HostPageTier(2)
        entry = tier.take(tier.put(src, "kv"))
        tpages.kv_page_insert(pool, entry.arrays, 5, flat=entry.flat)
        got = tpages.kv_page_fetch(pool, 5)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and np.array_equal(_np(w), _np(g))  # bitwise
        import jax.numpy as jnp

        jpool = {"f32": jnp.asarray(f32), "bf16": jnp.asarray(np.asarray(bf)).astype(jnp.bfloat16)}
        jsrc = ref.pages.kv_page_fetch(jpool, 3)
        assert [str(a.dtype) for a in jsrc] == ["bfloat16", "float32"]  # sorted keys
        assert all(np.array_equal(_np(a), _np(b)) for a, b in zip(want, jsrc))
        assert tpages.page_digest(want) == ref.pages.page_digest(jsrc)

    @pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
    def test_fetch_and_digest_equal_reference(self, ref, kind):
        """The same seeded page bytes: equal fetched arrays (dtype, shape,
        bits) in the reference's leaf order, equal digests; the port's
        insert puts them back bit for bit."""
        spec = _pool_bits(kind, seed={"bf16": 1, "int8": 2, "bcq4": 3}[kind])
        pool, jpool = _torch_pool(spec), _jax_pool(ref, spec)
        for pid in (1, 4):
            got, want = tpages.kv_page_fetch(pool, pid), ref.pages.kv_page_fetch(jpool, pid)
            assert [(tpages._dtype_name(a), tuple(a.shape)) for a in got] == \
                [(str(a.dtype), a.shape) for a in want]
            assert all(np.array_equal(_np(a), _np(b)) for a, b in zip(got, want))
            assert tpages.page_digest(got) == ref.pages.page_digest(want)
            tier = tpages.HostPageTier(1)
            entry = tier.take(tier.put(got, "kv"))
            before = {n: t.clone() for n, t in pool.items()}
            tpages.kv_page_insert(pool, entry.arrays, 5, flat=entry.flat)
            for n, t in pool.items():
                if t.ndim >= 3:
                    assert np.array_equal(_np(t[:, 5]), _np(before[n][:, pid]))
                else:
                    assert torch.equal(t, before[n])  # pool-global leaves stay

    def test_digest_is_order_and_content_sensitive(self, ref):
        def run(side):
            a = np.arange(8, dtype=np.float32)
            b = np.arange(8, dtype=np.float32) + 1
            d = side.pages.page_digest
            assert d([a, b]) != d([b, a]) and d([a]) != d([b]) and d([a]) == d([a.copy()])
            return d([a, b]), d([a]), d([np.zeros((2, 3), np.int8)])

        _both(ref, run)


# ------------------------------------------------------ engine: prefix
class TestHostPrefixHits:
    def test_evicted_prefix_pages_serve_from_host_exactly(self, ref):
        def run(side):
            eng = _engine(side)
            eng.submit(_req(side, 0, plen=16, max_new=1))
            eng.run_to_completion(max_ticks=30)
            assert eng.prefix.reclaimable_count() > 0
            demoted = 0
            while eng._evict_parked_page() is not None:
                demoted += 1
            assert demoted > 0 and _swap(eng)["swap_outs"] == demoted
            assert eng.prefix.host_count() == demoted and eng.prefix.reclaimable_count() == 0
            hits_before = eng.stats["prefix_hits"]
            again = _req(side, 0, plen=16, max_new=1)
            eng.submit(again)
            eng.run_to_completion(max_ticks=30)
            assert again.out == expected_greedy(again.prompt, 1)
            assert eng.stats["prefix_hits"] > hits_before and eng.prefix.host_hits > 0
            sw = _swap(eng)
            assert sw["verified_swapins"] > 0 and sw["corrupt_swapins"] == 0
            assert sw["swap_ins"] == sw["verified_swapins"]
            eng.audit(strict=True)
            assert _no_referenced_pages(eng)
            return _outcome(eng)

        out = _both(ref, run)
        assert "swap_out" in out[3] and "swap_in" in out[3]

    def test_disabled_tier_evictions_discard(self, ref):
        def run(side):
            eng = _engine(side, host_pages=0)
            assert eng.health()["host_tier"] is None
            eng.submit(_req(side, 0, plen=16, max_new=1))
            eng.run_to_completion(max_ticks=30)
            while eng._evict_parked_page() is not None:
                pass
            assert eng.prefix.host_count() == 0
            assert all(v == 0 for v in _swap(eng).values())
            return _outcome(eng)

        _both(ref, run)


# --------------------------------------------- engine: preempt → resume
class TestPreemptSwapResume:
    def test_preempted_decoder_resumes_from_host_exact(self, ref):
        def run(side):
            eng = _engine(side)
            req = _req(side, 0, plen=12, max_new=10)
            eng.submit(req)
            _step_until_decoding(eng, req)
            assert eng._preempt_one(None) is not None
            sw = _swap(eng)
            assert sw["swap_outs"] > 0
            assert eng.health()["host_tier"]["pinned"] == sw["swap_outs"]
            eng.audit(strict=True)  # the pinned carry is audit-clean while queued
            prefill_before = eng.stats["prefill_launches"]
            fin, _ = eng.run_to_completion(max_ticks=40)
            assert fin[0].rid == 0 and fin[0].error is None
            assert fin[0].out == expected_greedy(req.prompt, 10)
            assert eng.stats["prefill_launches"] == prefill_before  # no second prefill
            sw = _swap(eng)
            assert sw["verified_swapins"] == sw["swap_outs"]
            assert sw["swap_ins"] == sw["verified_swapins"] + sw["corrupt_swapins"]
            assert eng.health()["host_tier"]["pinned"] == 0
            eng.audit(strict=True)
            assert _no_referenced_pages(eng)
            return _outcome(eng)

        out = _both(ref, run)
        assert "swap_out_preempt" in out[3] and "swap_resume" in out[3]

    def test_double_preemption_folds_output_once(self, ref):
        def run(side):
            eng = _engine(side)
            req = _req(side, 0, plen=12, max_new=10)
            eng.submit(req)
            n1 = _step_until_decoding(eng, req)
            assert eng._preempt_one(None) is not None
            _step_until_decoding(eng, req, min_out=n1 + 2)
            assert eng._preempt_one(None) is not None
            fin, _ = eng.run_to_completion(max_ticks=60)
            assert fin[0].error is None and fin[0].out == expected_greedy(req.prompt, 10)
            assert eng.stats["preemptions"] == 2
            eng.audit(strict=True)
            assert _no_referenced_pages(eng)
            return _outcome(eng)

        _both(ref, run)

    def test_disabled_tier_preemption_is_pure_recompute(self, ref):
        def run(side):
            eng = _engine(side, host_pages=0)
            req = _req(side, 0, plen=12, max_new=10)
            eng.submit(req)
            _step_until_decoding(eng, req)
            assert eng._preempt_one(None) is not None
            fin, _ = eng.run_to_completion(max_ticks=40)
            assert fin[0].error is None and fin[0].out == expected_greedy(req.prompt, 10)
            assert all(v == 0 for v in _swap(eng).values())
            return _outcome(eng)

        _both(ref, run)

    def test_tier_too_small_for_carry_skips_to_recompute(self, ref):
        def run(side):
            eng = _engine(side, host_pages=1)
            req = _req(side, 0, plen=12, max_new=10)
            eng.submit(req)
            _step_until_decoding(eng, req)
            assert eng._preempt_one(None) is not None
            assert _swap(eng)["swap_outs"] == 0 and _swap(eng)["swap_skips"] >= 1
            fin, _ = eng.run_to_completion(max_ticks=40)
            assert fin[0].error is None and fin[0].out == expected_greedy(req.prompt, 10)
            assert _no_referenced_pages(eng)
            return _outcome(eng)

        _both(ref, run)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_forked_sibling_resumes_from_host(self, depth):
        """A greedy fork of 2; its youngest sibling is preempted and carried
        to host: the port finds the victim's slot by its index (not by
        comparing slots) and the sibling rejoins decode from its pages.
        (The reference's ``slots.index`` raises here, so the closed form is
        the yardstick.)"""
        eng = _engine(PORT, pipeline_depth=depth)
        req = _req(PORT, 0, plen=12, max_new=10, n_samples=2)
        eng.submit(req)
        _step_until_decoding(eng, req, min_out=3)
        victim = eng._preempt_one(None)
        assert victim is not None and victim != 0  # the sibling, admitted after its parent
        assert _swap(eng)["swap_outs"] > 0
        prefill_before = eng.stats["prefill_launches"]
        fin, _ = eng.run_to_completion(max_ticks=40)
        assert sorted((r.sample_idx, r.error) for r in fin) == [(0, None), (1, None)]
        for r in fin:
            assert r.out == expected_greedy(req.prompt, 10)
        assert eng.stats["prefill_launches"] == prefill_before
        assert "swap_resume" in _instants(eng)
        sw = _swap(eng)
        assert sw["verified_swapins"] == sw["swap_outs"] == sw["swap_ins"]
        eng.audit(strict=True)
        assert _no_referenced_pages(eng)


# ---------------------------------------------------- engine: fault seams
class TestSwapFaultSeams:
    def test_swap_out_fault_falls_back_to_recompute_exact(self, ref):
        def run(side):
            eng = _engine(side, side.FaultInjector(seed=0, rates={"swap_out": 1.0}))
            req = _req(side, 0, plen=12, max_new=10)
            eng.submit(req)
            _step_until_decoding(eng, req)
            assert eng._preempt_one(None) is not None
            assert _swap(eng)["swap_outs"] == 0 and _swap(eng)["swap_skips"] >= 1
            fin, _ = eng.run_to_completion(max_ticks=40)
            assert fin[0].error is None and fin[0].out == expected_greedy(req.prompt, 10)
            assert eng.health()["host_tier"]["used"] == 0
            eng.audit(strict=True)
            return _outcome(eng), [(e.tick, e.site, e.key) for e in eng.faults.log]

        _both(ref, run)

    def test_swap_in_fault_drops_carry_and_recomputes_exact(self, ref):
        def run(side):
            eng = _engine(side, side.FaultInjector(seed=0, rates={"swap_in": 1.0}))
            req = _req(side, 0, plen=12, max_new=10)
            eng.submit(req)
            _step_until_decoding(eng, req)
            assert eng._preempt_one(None) is not None
            assert _swap(eng)["swap_outs"] > 0  # the carry was made
            fin, _ = eng.run_to_completion(max_ticks=40)
            assert fin[0].error is None and fin[0].out == expected_greedy(req.prompt, 10)
            assert _swap(eng)["swap_ins"] == 0 and eng.health()["host_tier"]["used"] == 0
            eng.audit(strict=True)
            assert _no_referenced_pages(eng)
            return _outcome(eng), [(e.tick, e.site, e.key) for e in eng.faults.log]

        _both(ref, run)

    def test_corrupt_swap_in_quarantines_only_the_owner(self, ref):
        def run(side):
            eng = _engine(side, side.FaultInjector(seed=0, rates={"swap_corrupt": 1.0}))
            victim = _req(side, 0, plen=12, max_new=10)
            bystander = _req(side, 1, plen=12, max_new=10)
            eng.submit(victim)
            eng.submit(bystander)
            _step_until_decoding(eng, victim)
            idx = next(i for i, s in enumerate(eng.slots) if s.req is not None and s.req.rid == 0)
            assert eng._preempt_one(exclude=0 if idx != 0 else 1) is not None
            fin, _ = eng.run_to_completion(max_ticks=60)
            bad = [r for r in fin if r.error is not None]
            assert len(bad) == 1 and bad[0].error.kind == "quarantined"
            assert "integrity" in str(bad[0].error)
            ok = next(r for r in fin if r.rid == bystander.rid)
            assert ok.error is None and ok.out == expected_greedy(bystander.prompt, 10)
            sw = _swap(eng)
            assert sw["corrupt_swapins"] >= 1
            assert sw["swap_ins"] == sw["verified_swapins"] + sw["corrupt_swapins"]
            assert eng.health()["host_tier"]["used"] == 0
            eng.audit(strict=True)
            assert _no_referenced_pages(eng)
            return _outcome(eng), [(e.tick, e.site, e.key) for e in eng.faults.log]

        out = _both(ref, run)
        assert "swap_corrupt" in out[0][3]


# ------------------------------------------------- recompression ladder
def _warm(side, eng):
    eng.submit(_req(side, 0, plen=16, max_new=1))
    eng.run_to_completion(max_ticks=30)
    assert eng.prefix.reclaimable_count() > 0


def _force_pressure(eng, rounds=1):
    """Hold the pressure signal low so that ``_recompress_tick`` fires
    without exhausting the pool."""
    eng._available_pages = lambda: 0
    try:
        for _ in range(rounds):
            eng._recompress_tick(budget=8)
    finally:
        del eng._available_pages


class TestRecompressionLadder:
    def test_int8_stage_is_exact_for_integer_payloads(self, ref):
        def run(side):
            eng = _engine(side, recompress_after=1)
            _warm(side, eng)
            _force_pressure(eng)
            assert _swap(eng)["recompressed_pages"] > 0
            assert set(eng._recompress_stage.values()) == {1}  # int8
            again = _req(side, 0, plen=16, max_new=1)
            eng.submit(again)
            eng.run_to_completion(max_ticks=30)
            assert again.error is None and again.out == expected_greedy(again.prompt, 1)
            eng.audit(strict=True)
            return _outcome(eng), sorted(eng._recompress_stage.items())

        _both(ref, run)

    def test_bcq4_stage_stays_contained(self, ref):
        def run(side):
            eng = _engine(side, recompress_after=1)
            _warm(side, eng)
            _force_pressure(eng, rounds=2)
            assert max(eng._recompress_stage.values()) == 2  # bcq4
            again = _req(side, 0, plen=16, max_new=1)
            eng.submit(again)
            eng.run_to_completion(max_ticks=30)
            assert again.error is None
            eng.audit(strict=True)
            assert _no_referenced_pages(eng)
            return _outcome(eng), sorted(eng._recompress_stage.items())

        _both(ref, run)

    def test_stage_marker_travels_through_the_host_tier(self, ref):
        def run(side):
            eng = _engine(side, recompress_after=1)
            _warm(side, eng)
            _force_pressure(eng)
            staged = set(eng._recompress_stage)
            assert staged
            while eng._evict_parked_page() is not None:
                pass
            assert not (staged & set(eng._recompress_stage))
            again = _req(side, 0, plen=16, max_new=1)
            eng.submit(again)
            eng.run_to_completion(max_ticks=30)
            assert again.error is None and again.out == expected_greedy(again.prompt, 1)
            assert _swap(eng)["verified_swapins"] > 0
            assert 1 in eng._recompress_stage.values()  # re-acquired from the entry's meta
            eng.audit(strict=True)
            return _outcome(eng), sorted(eng._recompress_stage.items())

        _both(ref, run)


def _payload(kind, dtype, seed):
    """(L 3, ps 4, H 2, D 8) f32 values of one page: random, integer-valued
    within ±7, all zero, or .5 ties at a scale of 1 (|x| ≤ 7, half-odd)."""
    rng = np.random.default_rng(seed)
    shp = (3, 4, 2, 8)
    if kind == "random":
        x = rng.normal(size=shp) * 3
    elif kind == "integer":
        x = rng.integers(-7, 8, shp)
    elif kind == "zero":
        x = np.zeros(shp)
    else:  # amax exactly 7 · 1.0: scale 1, every other value on a .5 tie
        x = rng.integers(-6, 6, shp) + 0.5
        x.flat[0] = 7.0
    return x.astype(np.float32)


@pytest.mark.parametrize("payload", ["random", "integer", "zero", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_byte_equal_to_reference(ref, payload, dtype):
    """``_fake_quant`` at both ladder levels, and ``kv_page_recompress`` of
    a pool page through both stages (the reference's jitted path), byte
    for byte equal to the reference's on the same values."""
    import jax.numpy as jnp

    x = _payload(payload, dtype, seed=len(payload))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    for levels in (127, 7):
        got = tpages._fake_quant(tx, levels)
        want = ref.pages._fake_quant(jx, levels)
        assert got.dtype == tx.dtype and np.array_equal(_np(got), _np(want)), levels
    n_pages = 3
    base = np.random.default_rng(9).normal(size=(3, n_pages, 4, 2, 8)).astype(np.float32)
    base[:, 1] = x
    pool = {"k": torch.from_numpy(base).to(getattr(torch, dtype)),
            "k_idx": torch.zeros((3, n_pages, 4), dtype=torch.uint8)}
    jpool = {"k": jnp.asarray(base).astype(getattr(jnp, dtype)),
             "k_idx": jnp.zeros((3, n_pages, 4), jnp.uint8)}
    for stage in ("int8", "bcq4"):
        tpages.kv_page_recompress(pool, 1, stage)
        jpool = ref.pages.kv_page_recompress(jpool, 1, stage)
        assert np.array_equal(_np(pool["k"]), _np(jpool["k"])), stage


# ------------------------------------------------- depth 2 ≡ depth 1
# the stub schedule: a shared 16-token prefix (two full pages) over a pool
# of 12 pages — a decoding victim carried to host, parked pages demoted and
# hit from host, and (with the fault) one corrupt swap-in
DEPTH_STUB = dict(n_slots=3, max_len=64, page_size=8, n_pages=12, chunked_prefill=True,
                  prefill_chunk=16, host_pages=6)


def _stub_specs():
    base = np.arange(16) % VOCAB
    out = []
    for rid, (tail, max_new) in enumerate(((3, 12), (5, 10), (2, 14), (6, 8), (4, 9))):
        out.append((rid, np.concatenate([base, (np.arange(tail) * 5 + rid) % VOCAB]), max_new))
    return out


def _run_port(api, params, specs, depth, faults=None, second_wave=(), **kw):
    """Serve ``specs`` on a port engine at ``depth``; once it drains, demote
    every parked page to the host tier and serve ``second_wave``
    (resubmissions that hit host pages).  Returns every bit the two depths
    must share."""
    eng = PagedEngine(api, params, device="cpu", pipeline_depth=depth, fault_injector=faults,
                      **kw)
    for wave in (specs, second_wave):
        for rid, prompt, max_new in wave:
            eng.submit(tgen.Request(rid=rid, prompt=prompt, max_new=max_new))
        eng.run_to_completion(max_ticks=400)
        while eng._evict_parked_page() is not None:
            pass
    out = {(r.rid, r.sample_idx): (None if r.error is None else r.error.kind, list(r.out),
                                   list(r.margins), list(r.launch_ids)) for r in eng.finished}
    pool = {n: t.clone() for n, t in eng.pool.items()}
    log = sorted((e.tick, e.site, e.key) for e in faults.log) if faults is not None else []
    return (out, {k: eng.stats[k] for k in COUNTERS}, eng.health()["counters"], _swap(eng),
            eng.host_tier.snapshot(), eng.prefix.host_hits, log), pool


def _same(a, b):
    assert a[0] == b[0]
    assert a[1].keys() == b[1].keys() and all(torch.equal(a[1][n], b[1][n]) for n in a[1])


@pytest.mark.parametrize("fault", [None, "swap_corrupt"], ids=["clean", "corrupt"])
def test_depth2_equals_depth1_with_tier_on_stub(fault):
    specs = _stub_specs()
    wave2 = [(10 + rid, prompt, 4) for rid, prompt, _ in specs[:2]]
    sched = [(t, fault) for t in range(1, 200)] if fault else []
    runs = [_run_port(STUB, {}, specs, d, second_wave=wave2,
                      faults=FaultInjector(seed=0, schedule=sched, max_faults=1) if fault else None,
                      **DEPTH_STUB) for d in (1, 2)]
    _same(runs[0], runs[1])
    (out, stats, counters, sw, snap, host_hits, log), _ = runs[0]
    assert stats["preemptions"] > 0 and sw["swap_outs"] > 0 and host_hits > 0
    assert sw["swap_ins"] == sw["verified_swapins"] + sw["corrupt_swapins"]
    if fault:
        assert sw["corrupt_swapins"] == 1 and counters["quarantined"] == 1
        assert [e[1] for e in log] == ["swap_corrupt"]
    else:
        assert sw["corrupt_swapins"] == 0 and all(v[0] is None for v in out.values())
        for (rid, _), v in out.items():
            prompt = next(p for r, p, _ in specs + wave2 if r == rid)
            assert v[1] == expected_greedy(prompt, len(v[1]) - 1)


# ------------------------------------------- smoke gpt3_126m, W4A4, bcq4
PS, CHUNK, SLOTS, MAX_LEN = 8, 16, 4, 32
W4A4_ENGINE = dict(n_slots=SLOTS, max_len=MAX_LEN, page_size=PS, prefill_chunk=CHUNK,
                   chunked_prefill=True)


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


def _w4a4_prompts(vocab):
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, vocab, 2 * PS)
    return [np.concatenate([prefix, rng.integers(0, vocab, n)]) for n in (3, 6)]


def _preempt_resume(eng, mod, prompts, corrupt_at=None):
    """Two requests on a shared prefix; after 4 ticks (drained: the same
    state at every depth) the youngest, request 1, is preempted and carried
    to host; then all parked pages are demoted and request 0's prompt comes
    again (host prefix hits).  No admission waits for a slot."""
    reqs = [mod.Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    eng.drain()
    assert len(reqs[1].out) >= 2
    assert eng._preempt_one(None) == 1  # the youngest: request 1's slot
    eng.run_to_completion(max_ticks=200)
    while eng._evict_parked_page() is not None:
        pass
    eng.submit(mod.Request(rid=2, prompt=prompts[0], max_new=3))
    eng.run_to_completion(max_ticks=200)
    return eng


def test_depth2_equals_depth1_with_tier_w4a4(w4a4):
    """The port at depth 2 against its depth 1 on the smoke W4A4/bcq4 model
    with the tier on: a preemption carried to host and resumed, parked
    pages demoted and hit from host, and (second case) a corrupt swap-in
    — bit for bit: tokens, margins, launch ids, error kinds, counters, swap
    counters, tier snapshot, pool bytes."""
    prompts = _w4a4_prompts(w4a4.vocab)
    for fault in (None, [(t, "swap_corrupt", 1) for t in range(1, 60)]):
        runs = []
        for depth in (1, 2):
            faults = FaultInjector(seed=0, schedule=fault, max_faults=1) if fault else None
            eng = PagedEngine(w4a4.tapi, w4a4.tparams, device="cpu", pipeline_depth=depth,
                              host_pages=8, fault_injector=faults, **W4A4_ENGINE)
            _preempt_resume(eng, tgen, prompts)
            out = {(r.rid, r.sample_idx): (None if r.error is None else r.error.kind,
                                           list(r.out), list(r.margins), list(r.launch_ids))
                   for r in eng.finished}
            runs.append(((out, {k: eng.stats[k] for k in COUNTERS}, _swap(eng),
                          eng.host_tier.snapshot(), eng.health()["counters"]),
                         {n: t.clone() for n, t in eng.pool.items()}))
        _same(runs[0], runs[1])
        (out, stats, sw, _, counters), _ = runs[0]
        assert stats["preemptions"] == 1 and sw["swap_outs"] > 0 and sw["swap_ins"] > 0
        assert sw["swap_ins"] == sw["verified_swapins"] + sw["corrupt_swapins"]
        assert sw["corrupt_swapins"] == (1 if fault else 0)
        assert counters["quarantined"] == (1 if fault else 0)


def test_port_matches_reference_with_tier_w4a4(ref, w4a4):
    """The preempt-and-resume workload on both engines at depth 1: the
    reference's tokens held to the port's under the margin rule (the
    reference records no margins or launch ids: the port's stand in), equal
    engine and swap counters and host hits."""
    prompts = _w4a4_prompts(w4a4.vocab)
    jeng = _preempt_resume(ref.Engine(w4a4.japi, w4a4.jparams, host_pages=8, **W4A4_ENGINE),
                           ref.gen, prompts)
    teng = _preempt_resume(PagedEngine(w4a4.tapi, w4a4.tparams, device="cpu", host_pages=8,
                                       **W4A4_ENGINE), tgen, prompts)
    got = {(r.rid, r.sample_idx): r for r in teng.finished}
    want = {(r.rid, r.sample_idx): SimpleNamespace(
        out=list(r.out), launch_ids=got[(r.rid, r.sample_idx)].launch_ids,
        margins=got[(r.rid, r.sample_idx)].margins) for r in jeng.finished}
    agree = tgen.greedy_agreement(want, got, TOL)
    assert agree["ok"] and agree["equal_tokens"] > 0, agree
    assert {k: jeng.stats[k] for k in COUNTERS} == {k: teng.stats[k] for k in COUNTERS}
    assert _swap(jeng) == _swap(teng) and _swap(teng)["swap_ins"] > 0
    assert jeng.prefix.host_hits == teng.prefix.host_hits > 0
    assert "swap_resume" in _instants(teng) and _instants(jeng) == _instants(teng)


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels; no interpret mode)")
    return torch.device("cuda")


def _card_api(cuda):
    from repro_torch.configs.base import get_smoke as t_get_smoke
    from repro_torch.models import zoo as tzoo
    from repro_torch.models.layers import Runtime as TRuntime

    trt = TRuntime(quant_mode="packed", compute_dtype=torch.float32, cache_kind="bcq4",
                   paged_kernel=True, fused_linear=True)
    api = tzoo.build(t_get_smoke("gpt3_126m"), trt, device=cuda)
    return api, api.init(0)


def _card_serve(api, params, disturb=None):
    """Two requests at graph depth 2; after 4 steps (drained) ``disturb``
    is called on the engine, then the run completes."""
    eng = PagedEngine(api, params, device=api.device, pipeline_depth=2, cuda_graphs=True,
                      host_pages=16, **W4A4_ENGINE)
    rng = np.random.default_rng(5)
    for rid in range(2):
        eng.submit(tgen.Request(rid=rid, prompt=rng.integers(0, api.cfg.vocab, 11), max_new=8))
    for _ in range(4):
        eng.step()
    eng.drain()
    if disturb is not None:
        disturb(eng)
    eng.run_to_completion()
    torch.cuda.synchronize()
    return {(r.rid, r.sample_idx): (r.out, r.margins) for r in eng.finished}, eng


@pytest.mark.cuda
def test_graph_replay_reads_swapped_in_page(cuda):
    """Mid-run, every live page of slot 0 goes to the tier, is zeroed in
    place and comes back by ``kv_page_insert``: the captured decode graph
    reads the restored bytes, so the run equals the undisturbed one bit
    for bit, while a run that leaves the pages zeroed does not."""
    api, params = _card_api(cuda)
    want, eng0 = _card_serve(api, params)
    assert eng0.trace_counts()["decode"] >= 1

    def round_trip(eng, restore=True):
        tier = eng.host_tier
        for pid in tpages.live_pages(eng.tables[0]):
            handle = tier.put(tpages.kv_page_fetch(eng.pool, pid), "kv", pinned=True)
            for leaf in tpages._page_leaves(eng.pool):
                leaf[:, pid].zero_()
            entry = tier.take(handle)
            if restore:
                tpages.kv_page_insert(eng.pool, entry.arrays, pid, flat=entry.flat)

    got, _ = _card_serve(api, params, round_trip)
    assert got == want
    zeroed, _ = _card_serve(api, params, functools.partial(round_trip, restore=False))
    assert zeroed != want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
def test_swap_round_trip_bitwise_on_card(cuda, kind):
    """fetch → put → take → insert on a CUDA pool: the page bytes land
    bit for bit, and the fetched arrays (and digest) equal those of the
    same bytes fetched on the CPU."""
    spec = _pool_bits(kind, seed=7)
    cpu = _torch_pool(spec)
    pool = {n: t.to(cuda) for n, t in cpu.items()}
    got = tpages.kv_page_fetch(pool, 2)
    assert all(a.is_pinned() for a in got)
    want = tpages.kv_page_fetch(cpu, 2)
    assert tpages.page_digest(got) == tpages.page_digest(want)
    tier = tpages.HostPageTier(2)
    entry = tier.take(tier.put(got, "kv"))
    assert entry.flat.is_pinned()
    tpages.kv_page_insert(pool, entry.arrays, 4, flat=entry.flat)
    torch.cuda.synchronize()
    for n, t in pool.items():
        if t.ndim >= 3:
            assert torch.equal(t[:, 4].cpu().view(torch.uint8), cpu[n][:, 2].view(torch.uint8))


@pytest.mark.cuda
def test_swap_out_at_depth2_sees_inflight_writes(cuda):
    """Right after a depth-2 step, with its decode launch still in flight,
    ``kv_page_fetch`` of the page that launch writes returns the bytes the
    launch wrote (the copy is ordered after it on the stream)."""
    api, params = _card_api(cuda)
    eng = PagedEngine(api, params, device=cuda, pipeline_depth=2, cuda_graphs=True,
                      **W4A4_ENGINE)
    eng.submit(tgen.Request(rid=0, prompt=np.arange(11) % api.cfg.vocab, max_new=12))
    while not eng._inflight or eng.slots[0].mode != "decode":
        eng.step()
    checked = 0
    for _ in range(4):
        pos = eng.slots[0].pos
        pid = int(eng.tables[0][pos // PS])
        if pid == tpages.NULL_PAGE:
            eng.step()
            continue
        before = tpages.kv_page_fetch(eng.pool, pid)
        eng.step()  # launches the row that writes position pos, syncs the older one
        assert eng._inflight
        during = tpages.kv_page_fetch(eng.pool, pid)
        torch.cuda.synchronize()
        after = tpages.kv_page_fetch(eng.pool, pid)
        assert tpages.page_digest(during) == tpages.page_digest(after)
        assert tpages.page_digest(before) != tpages.page_digest(after)
        checked += 1
    assert checked
    eng.run_to_completion()
