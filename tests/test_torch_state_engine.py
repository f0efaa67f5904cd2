"""The port's state-checkpoint serving layout (``serving/state_engine.py``:
``StatePagedEngine`` over ``state`` pages) against the JAX package's, on the
2-layer ``mamba2_130m`` smoke — the port's counterparts of
``tests/test_state_paged.py``'s ``mamba2_130m`` cases.

Both packages serve the reference's weights (``convert.from_numpy_tree``)
with numpy-seeded prompts; every engine here has 4 slots, max_len 64 and
page 8, and the prompts few lengths, so the reference compiles its step
functions once per shape (one JAX model per mode, ``lru_cache``).

Held here:

* paged ≡ contiguous at depths 1 and 2 (``quant_mode="none"``): the
  port's tokens equal the port's ``greedy_generate`` and the reference
  engine's, bit for bit; no ``kv`` page is ever held;
* W4A4 (``packed``): port engine vs reference engine under the margin rule
  (``TOL`` 1e-3, as tests/test_torch_engine.py; the reference records no
  margins, so the port's judge), counters equal; the port's depth 2 equal
  to its depth 1 bit for bit (tokens, margins, launch ids, counters, live
  tree and state pool bytes), with a preemption, a fork and sampling;
* bounded replay: a preempted request resumes from its checkpoint with
  0 < replayed ≤ page_size tokens, bit-identical at ``none``; under W4A4 a
  batch-1 replay launch has its own activation scale, so the resumed
  tokens are held to the never-preempted run by the margin rule and to
  the reference's own preempted run;
* the host tier: zero-replay resume bit-identical, a refused swap-in
  falling back to the checkpoint replay, a corrupt swap-in quarantining
  only its owner;
* forks (greedy identical, sampled reproducible and divergent), a chaos
  schedule contained with clean audits, typed rejection of the wrong
  engine, the KV engine's pages typed ``kv`` after the split, and the CLI.

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
from repro_torch.models import zoo as tzoo
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import generate as tgen
from repro_torch.serving import pages as tpages
from repro_torch.serving.audit import audit_engine
from repro_torch.serving.engine import PagedEngine
from repro_torch.serving.faults import FaultInjector as TFaults
from repro_torch.serving.state_engine import StatePagedEngine

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.core.bcq import BCQConfig as JCfg  # noqa: E402
from repro.core.calibrate import default_universal_codebooks  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro.serving import generate as jgen  # noqa: E402
from repro.serving.state_engine import StatePagedEngine as JStateEngine  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2_130m"
CFG, TCFG = get_smoke(ARCH), t_get_smoke(ARCH)
SLOTS, ML, PS, S = 4, 64, 8, 12
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


@functools.lru_cache(maxsize=None)
def _models(mode):
    """(reference api, its params, port api, its params) for ``mode``."""
    jrt = JRuntime(quant_mode=mode, compute_dtype=jnp.float32, param_dtype=jnp.float32)
    params = jzoo.build(CFG, dataclasses.replace(jrt, quant_mode="none")).init(
        jax.random.PRNGKey(0))
    if mode == "packed":
        cb = default_universal_codebooks(JCfg()).as_jnp()
        params = jptq.pack_params(params, cb, JCfg())
        params["codebooks"] = cb
    tapi = tzoo.build(TCFG, TRuntime(quant_mode=mode, compute_dtype=torch.float32), device="cpu")
    return (jzoo.build(CFG, jrt), params, tapi,
            from_numpy_tree(jax.tree.map(np.asarray, params)))


def _prompts(n=3, seed=5):
    return [np.random.default_rng(seed + i).integers(0, CFG.vocab, S) for i in range(n)]


def _engine(mode, **kw):
    kw.setdefault("n_slots", SLOTS)
    _, _, tapi, tparams = _models(mode)
    return StatePagedEngine(tapi, tparams, max_len=ML, page_size=PS, device="cpu", **kw)


def _ref_engine(mode, **kw):
    japi, jparams, _, _ = _models(mode)
    return JStateEngine(japi, jparams, n_slots=SLOTS, max_len=ML, page_size=PS, **kw)


def _serve(eng, gen, prompts, max_new=7, **req):
    reqs = [gen.Request(rid=i, prompt=p, max_new=max_new, **req) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return reqs


def _preempted(eng, gen, prompt, rid=1, ticks=9, max_new=19):
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
    contiguous = tgen.greedy_generate(tapi, tparams, np.stack(prompts), 8, 32, device="cpu")
    eng = _engine("none", pipeline_depth=depth)
    reqs = _serve(eng, tgen, prompts)
    ref, stats, _ = _ref_tokens("none")
    for i, r in enumerate(reqs):
        assert r.done and r.error is None
        assert r.out == contiguous[i].tolist() == ref[i], i
    assert {k: eng.stats[k] for k in STAT_KEYS} == stats
    assert eng.pool_mgr.used_by_kind()["kv"] == 0
    assert eng.health()["state_counters"]["state_checkpoints"] > len(prompts)


def test_packed_engine_matches_reference_and_depth2_is_depth1():
    """W4A4: the reference engine's tokens under the margin rule (here all
    equal) and counters; depth 2 ≡ depth 1 bit for bit."""
    ref, stats, jreqs = _ref_tokens("packed")
    outs = {}
    for depth in (1, 2):
        eng = _engine("packed", pipeline_depth=depth)
        reqs = _serve(eng, tgen, _prompts())
        outs[depth] = _outcome(eng, reqs)
        agree = _agree(jreqs, reqs)
        assert agree["ok"] and agree["equal_tokens"] == sum(map(len, ref)), agree
        assert {k: eng.stats[k] for k in STAT_KEYS} == stats
    _same_outcome(outs[1], outs[2])


def test_depth2_equals_depth1_with_preemption_fork_and_sampling():
    sp = tgen.SamplingParams(temperature=0.9, top_k=20, seed=7)
    outs = []
    for depth in (1, 2):
        eng = _engine("packed", pipeline_depth=depth)
        reqs = [tgen.Request(rid=0, prompt=_prompts()[0], max_new=17),
                tgen.Request(rid=1, prompt=_prompts()[1], max_new=9, n_samples=2, sampling=sp)]
        for r in reqs:
            eng.submit(r)
        for _ in range(6):
            eng.step()
        assert eng._preempt_one(None) is not None  # drains first at depth 2
        eng.run_to_completion()
        fin = sorted(eng.finished, key=lambda r: (r.rid, r.sample_idx))
        assert len(fin) == 3 and all(r.error is None for r in fin)
        outs.append(_outcome(eng, fin))
    _same_outcome(*outs)


# ----------------------------------------------- bounded-replay preemption
@pytest.mark.parametrize("depth", [1, 2])
def test_preempt_resume_bounded_replay(depth):
    prompt = _prompts(1)[0]
    e0 = _engine("none", pipeline_depth=depth)
    (r0,) = _serve(e0, tgen, [prompt], max_new=19)
    e1 = _engine("none", pipeline_depth=depth)
    r1, n_before = _preempted(e1, tgen, prompt)
    assert r1.out == r0.out
    cs = e1.health()["state_counters"]
    assert cs["state_restores"] == 1
    assert 0 < cs["replay_tokens"] <= PS
    assert cs["replay_tokens"] < len(prompt) + n_before


def test_packed_replay_matches_reference_and_counts_flips():
    """Under W4A4 the batch-1 replay launches have their own activation
    scales.  The port's preempted run equals the reference's (the same
    launches) under the margin rule; against the never-preempted run the
    tokens agree up to the preemption and may part from the first resumed
    one on (with this smoke's random weights most margins are below 0.1,
    so they do: the flips are counted, not bounded)."""
    prompt = _prompts(1)[0]
    (r0,) = _serve(_engine("packed"), tgen, [prompt], max_new=19)
    e1 = _engine("packed")
    r1, n_before = _preempted(e1, tgen, prompt)
    j1, _ = _preempted(_ref_engine("packed"), jgen, prompt)
    agree = _agree([j1], [r1])
    assert agree["ok"] and agree["equal_tokens"] == len(r1.out), agree
    assert r1.out[:n_before] == r0.out[:n_before] and len(r1.out) == len(r0.out)
    flips = sum(a != b for a, b in zip(r0.out, r1.out))
    assert flips <= len(r1.out) - n_before
    assert 0 < e1.health()["state_counters"]["replay_tokens"] <= PS


# ------------------------------------------- host-tier zero-replay resume
def test_preempt_resume_from_host_zero_replay():
    prompt = _prompts(1)[0]
    (r0,) = _serve(_engine("none"), tgen, [prompt], max_new=19)
    e1 = _engine("none", host_pages=8)
    r = tgen.Request(rid=1, prompt=prompt, max_new=19)
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
                     for leaf in tpages.tree_leaves(e1.spool))
    assert sw["swap_bytes"] == 2 * page_bytes  # one page out, one in
    assert e1.health()["host_tier"] == {"used": 0, "capacity": 8, "bytes_resident": 0,
                                        "pinned": 0}


def test_host_swap_in_fault_falls_back_to_checkpoint_replay():
    prompt = _prompts(1)[0]
    (r0,) = _serve(_engine("none"), tgen, [prompt], max_new=19)
    e1 = _engine("none", host_pages=8, fault_injector=TFaults(seed=1, rates={"swap_in": 1.0}))
    r1, _ = _preempted(e1, tgen, prompt)
    assert r1.error is None and r1.out == r0.out
    assert 0 < e1.health()["state_counters"]["replay_tokens"] <= PS
    assert e1.health()["host_tier"]["used"] == 0  # the refused carry dropped


def test_host_swap_corrupt_quarantines_owner():
    prompt = _prompts(1)[0]
    eng = _engine("none", host_pages=8,
                  fault_injector=TFaults(seed=1, rates={"swap_corrupt": 1.0}))
    r = tgen.Request(rid=0, prompt=prompt, max_new=19)
    eng.submit(r)
    for _ in range(9):
        eng.step()
    assert eng._preempt_one(None) is not None
    fin, _ = eng.run_to_completion()
    bad = [x for x in fin if x.error is not None]
    assert len(bad) == 1 and bad[0].error.kind == "quarantined"
    assert "integrity" in str(bad[0].error)
    sw = eng.health()["swap"]
    assert sw["corrupt_swapins"] == 1 and sw["swap_ins"] == sw["verified_swapins"] + 1
    assert eng.health()["host_tier"]["used"] == 0
    assert int((eng.pool_mgr.refcount > 0).sum()) == 0


# ------------------------------------------------------------------- forks
def test_greedy_fork_identical():
    prompt = _prompts(1)[0]
    (r0,) = _serve(_engine("none"), tgen, [prompt], max_new=9)
    eng = _engine("none")
    eng.submit(tgen.Request(rid=1, prompt=prompt, max_new=9, n_samples=2))
    fin, _ = eng.run_to_completion()
    assert len(fin) == 2 and all(r.error is None and r.out == r0.out for r in fin)
    assert eng.stats["forks"] == 1 and eng.stats["shared_pages"] == 1


def test_sampled_fork_deterministic_and_divergent():
    sp = tgen.SamplingParams(temperature=0.9, top_k=20, seed=7)

    def outs():
        eng = _engine("none")
        eng.submit(tgen.Request(rid=2, prompt=_prompts(1)[0], max_new=9, n_samples=3,
                                sampling=sp))
        fin, _ = eng.run_to_completion()
        assert all(x.error is None for x in fin)
        return {x.sample_idx: x.out for x in fin}

    a, b = outs(), outs()
    assert a == b
    assert len({tuple(v) for v in a.values()}) > 1


# ------------------------------------------------------------------ chaos
def test_chaos_contained():
    """tests/test_state_paged.py's schedule: dry allocations at ticks 2–5
    (admission and boundary checkpoints skip) and slot 1's logits poisoned
    at tick 4; the survivors match the clean run."""
    prompt = _prompts(1)[0]
    (r0,) = _serve(_engine("none", n_slots=3), tgen, [prompt], max_new=9)
    faults = TFaults(seed=3, schedule=[(2, "alloc"), (3, "alloc"), (4, "alloc"), (5, "alloc"),
                                       (4, "logits", 1)])
    eng = _engine("none", n_slots=3, fault_injector=faults, audit_every=1)
    reqs = _serve(eng, tgen, [prompt] * 3, max_new=9)
    assert eng.health()["counters"]["audit_failures"] == 0
    ok = [r for r in reqs if r.error is None]
    assert ok and all(r.out == r0.out for r in ok)
    assert all(r.error.kind == "quarantined" for r in reqs if r.error is not None)
    assert faults.counts().get("logits") == 1


# ------------------------------------------------- typed family rejection
def test_wrong_engine_raises_typed():
    _, _, tapi, tparams = _models("none")
    kv = tzoo.build(t_get_smoke("gpt3_126m"), TRuntime(compute_dtype=torch.float32),
                    device="cpu")
    with pytest.raises(tzoo.UnsupportedModelError) as ei:
        StatePagedEngine(kv, kv.init(0), n_slots=2, max_len=ML, page_size=PS, device="cpu")
    assert ei.value.family == "dense"
    assert "state_checkpoint" in str(ei.value) and "paged-servable families" in str(ei.value)
    with pytest.raises(tzoo.UnsupportedModelError):
        PagedEngine(tapi, tparams, n_slots=2, max_len=ML, page_size=PS, device="cpu")


def test_kv_engine_pages_are_typed_kv():
    """After the split the KV engine allocates ``kv`` pages only, and the
    telemetry's per-kind gauges sum to ``pool_pages_used``."""
    kv = tzoo.build(t_get_smoke("gpt3_126m"), TRuntime(compute_dtype=torch.float32),
                    device="cpu")
    eng = PagedEngine(kv, kv.init(0), n_slots=2, max_len=32, page_size=8, device="cpu")
    assert eng.PAGE_LAYOUT == "kv" and eng.HOST_SWAP_KIND == "kv"
    for p in _prompts(2):
        eng.submit(tgen.Request(rid=0, prompt=p, max_new=3))
    eng.step()
    kinds = eng.pool_mgr.used_by_kind()
    assert kinds["kv"] == eng.pool_mgr.used() > 0 and kinds["state"] == kinds["shared_ro"] == 0
    eng.run_to_completion()
    g = eng.snapshot()["gauges"]
    assert sum(g[f"pool_pages_{k}"] for k in tpages.PAGE_KINDS) == g["pool_pages_used"]
    assert audit_engine(eng).ok


def test_state_gauges_sum_to_used():
    eng = _engine("none")
    eng.submit(tgen.Request(rid=0, prompt=_prompts(1)[0], max_new=3))
    eng.step()
    g = eng.snapshot()["gauges"]
    assert g["pool_pages_state"] == g["pool_pages_used"] == 1 and g["pool_pages_kv"] == 0
    eng.run_to_completion()


# -------------------------------------------------------------------- CLI
def test_cli_contiguous_paged_and_chaos(tmp_path, capsys):
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


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch.serve import main

    _, _, tapi, tparams = _models("none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StatePagedEngine(tapi, tparams, n_slots=2, max_len=ML, page_size=PS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.build(TCFG, TRuntime())
    for paged in ([], ["--paged"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--arch", ARCH, "--smoke", "--batch", "1", "--gen", "2"] + paged)
