"""The port's enc-dec (``whisper_base``) served through ``StatePagedEngine``
with its encoder output in ``shared_ro`` pages, against the JAX package's
engine, on the smoke (2 + 2 layers, d 128, 64 frames) with a bcq4 self
cache — the port's counterparts of ``tests/test_state_paged.py``'s
``whisper_base`` cases.

Both packages serve the port's seeded weights (``zoo.build(...).init(0)``;
the packed tree is byte for byte the reference's ``pack_params``:
tests/test_torch_encdec.py), carried into the reference as numpy arrays;
frames are numpy-seeded normals · 0.02 and prompts numpy-seeded 6-token
arrays.  Every engine here has 2 slots, max_len 32 and page 8 (so the
reference compiles its step functions once a mode), and prompts of one
length.

Held here:

* paged ≡ contiguous at depths 1 and 2 (``quant_mode="none"``): the port's
  tokens equal its ``generate_contiguous`` and the reference engine's bit
  for bit, with the reference's counters and encoder launches;
* W4A4 (``packed``): port engine vs reference engine under the margin rule
  (``TOL`` 1e-3; the port's margins judge both), at depths 1 and 2; the
  port's depth 2 equal to its depth 1 bit for bit (tokens, margins, launch
  ids, counters, live tree, state pool and encoder pool bytes);
* ``encoder_launches`` equal to the reference's in every shared-page
  scenario: two requests over the same frames (one launch, a prefix hit
  that skips 64 frames), a preempted request resumed from its checkpoint
  and from the host tier (neither encodes again; tokens bit-identical at
  ``none``), a best-of-2 fork (the siblings share the encoder page), an
  injected dropped prefix claim (a second encode), and parked encoder
  pages evicted under pressure (never put in the host tier; encoded
  again on the next request);
* the audit clean after every engine (``_audit_engines``); the serve CLI
  contiguous, ``--paged`` and ``--chaos`` at ``--smoke --device cpu``.
"""
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
from repro_torch.serving import faults as tfaults
from repro_torch.serving import generate as tgen
from repro_torch.serving import pages as tpages
from repro_torch.serving.audit import audit_engine
from repro_torch.serving.state_engine import StatePagedEngine

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import generate as jgen  # noqa: E402
from repro.serving.state_engine import StatePagedEngine as JStateEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper_base"
CFG, TCFG = get_smoke(ARCH), t_get_smoke(ARCH)
SLOTS, ML, PS, S, GEN = 2, 32, 8, 6, 13
TOL = 1e-3
STAT_KEYS = ("prefill_launches", "prefill_tokens", "decode_ticks", "forks", "shared_pages",
             "preemptions", "prefix_hits", "prefix_misses", "prefill_tokens_skipped",
             "prefix_evictions")


@pytest.fixture(autouse=True)
def _audit_engines(monkeypatch):
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
    """(reference api, its params, port api, its params) for ``mode``."""
    jrt, trt = _rts(mode)
    tapi = tzoo.build(TCFG, trt, device="cpu")
    tparams = tapi.init(0)
    return jzoo.build(CFG, jrt), _to_reference(tparams), tapi, tparams


def _frames(seed):
    return (np.random.default_rng(100 + seed).normal(size=(CFG.encoder_len, CFG.d_model))
            * 0.02).astype(np.float32)


def _prompts(n=3, seed=5):
    return [np.random.default_rng(seed + i).integers(0, CFG.vocab, S) for i in range(n)]


def _engine(mode, **kw):
    _, _, tapi, tparams = _models(mode)
    return StatePagedEngine(tapi, tparams, n_slots=SLOTS, max_len=ML, page_size=PS,
                            device="cpu", **kw)


def _ref_engine(mode, **kw):
    japi, jparams, _, _ = _models(mode)
    return JStateEngine(japi, jparams, n_slots=SLOTS, max_len=ML, page_size=PS, **kw)


def _requests(gen, prompts, frames, max_new=GEN, **req):
    return [gen.Request(rid=i, prompt=p, max_new=max_new, frames=f, **req)
            for i, (p, f) in enumerate(zip(prompts, frames))]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return reqs


def _encodes(eng):
    return eng._cs["encoder_launches"].value


def _counters(eng):
    return {k: eng.stats[k] for k in STAT_KEYS} | {"encoder_launches": _encodes(eng)}


# three requests: two over frames 0 (a hit), one over frames 1
WORK = (_prompts(), [_frames(0), _frames(1), _frames(0)])


def _agree(jfin, tfin):
    """The margin rule over port vs reference requests (the port's margins
    and launches judge both)."""
    got = {(r.rid, r.sample_idx): r for r in tfin}
    ref = {k: SimpleNamespace(out=list(map(int, r.out)), launch_ids=list(got[k].launch_ids),
                              margins=[0.0] * len(r.out))
           for r in jfin for k in [(r.rid, r.sample_idx)]}
    return tgen.greedy_agreement(ref, got, TOL)


@functools.lru_cache(maxsize=None)
def _ref_run(mode):
    eng = _ref_engine(mode)
    reqs = _serve(eng, _requests(jgen, *WORK))
    return [list(map(int, r.out)) for r in reqs], _counters(eng), reqs


def _outcome(eng, reqs):
    return ([(r.out, r.margins, r.launch_ids, None if r.error is None else r.error.kind)
             for r in reqs],
            {k: v for k, v in eng.stats.items() if not k.startswith("t_")},  # no clocks
            eng.health()["state_counters"],
            [tpages.tree_leaves(t) for t in (eng.live, eng.spool)] + [list(eng.enc_pool)])


def _same_outcome(a, b):
    assert a[:3] == b[:3]
    for ta, tb in zip(a[3], b[3]):
        for x, y in zip(ta, tb):
            assert torch.equal(x, y)


# ------------------------------------------------------- token equivalence
@pytest.mark.parametrize("depth", [1, 2])
def test_state_paged_matches_contiguous_and_reference(depth):
    """``none``: the engine's tokens equal the contiguous path's (each
    request alone over its frames) and the reference engine's; the
    counters and encoder launches are the reference's (2 encodes, 1 hit)."""
    from repro_torch.launch.serve import generate_contiguous

    _, _, tapi, tparams = _models("none")
    eng = _engine("none", pipeline_depth=depth)
    reqs = _serve(eng, _requests(tgen, *WORK))
    ref, counters, _ = _ref_run("none")
    for i, (r, p, f) in enumerate(zip(reqs, *WORK)):
        assert r.done and r.error is None
        alone = generate_contiguous(tapi, TCFG, tparams, p[None], f, GEN + 1, ML, device="cpu")
        assert r.out == alone[0].tolist() == ref[i], i
    assert _counters(eng) == counters
    assert counters["encoder_launches"] == 2 and counters["prefix_hits"] == 1
    assert eng.stats["prefill_tokens_skipped"] == CFG.encoder_len
    assert eng.pool_mgr.used_by_kind() == {"kv": 0, "state": 0, "shared_ro": 2}  # parked


def test_packed_engine_matches_reference_and_depth2_is_depth1():
    """W4A4: the reference engine's tokens under the margin rule, its
    counters; depth 2 ≡ depth 1 bit for bit, the encoder pool included."""
    _, counters, jreqs = _ref_run("packed")
    outs = {}
    for depth in (1, 2):
        eng = _engine("packed", pipeline_depth=depth)
        reqs = _serve(eng, _requests(tgen, *WORK))
        outs[depth] = _outcome(eng, reqs)
        agree = _agree(jreqs, reqs)
        assert agree["ok"], agree
        assert _counters(eng) == counters
    _same_outcome(outs[1], outs[2])


# ----------------------------------------------- the shared encoder page
def test_shared_encoder_page_zero_encode_on_hit():
    """Two requests over the SAME frames: one encoder launch, the second
    request's page a prefix hit; the reference's count; outputs equal to
    the contiguous path; the finished page parked, kind-tagged."""
    from repro_torch.launch.serve import generate_contiguous

    _, _, tapi, tparams = _models("none")
    prompts, frames = _prompts(2), [_frames(0)] * 2
    eng = _engine("none")
    reqs = _serve(eng, _requests(tgen, prompts, frames))
    jeng = _ref_engine("none")
    _serve(jeng, _requests(jgen, prompts, frames))
    assert _encodes(eng) == _encodes(jeng) == 1
    assert eng.stats["prefix_hits"] == jeng.stats["prefix_hits"] == 1
    want = generate_contiguous(tapi, TCFG, tparams, np.stack(prompts), frames[0], GEN + 1, ML,
                               device="cpu")
    assert [r.out for r in reqs] == want.tolist()
    assert eng.pool_mgr.used_by_kind()["shared_ro"] == 1
    assert eng.prefix.reclaimable_count() == 1


def _preempted(eng, gen, prompt, frames, ticks=5):
    """One request, preempted mid-generation after ``ticks`` steps, served
    to the end.  Returns (request, tokens it had before the preemption)."""
    r = gen.Request(rid=1, prompt=prompt, max_new=GEN, frames=frames)
    eng.submit(r)
    for _ in range(ticks):
        eng.step()
    eng.drain()
    n_before = len(r.out)
    assert 0 < n_before < GEN + 1, "must preempt mid-generation"
    assert eng._preempt_one(None) is not None
    assert eng.queue[0]._enc_page is not None  # the encoder page travels with it
    if isinstance(eng, StatePagedEngine):
        assert audit_engine(eng).ok  # the carried refs stay accounted
    else:
        eng.audit(strict=True)
    eng.run_to_completion()
    return r, n_before


@pytest.mark.parametrize("depth", [1, 2])
def test_preempt_resume_does_not_encode_again(depth):
    """A checkpoint resume replays at most page_size tokens, encodes
    nothing (the reference's count) and gives the never-preempted run's
    tokens."""
    prompt, frames = _prompts(1)[0], _frames(0)
    (r0,) = _serve(_engine("none", pipeline_depth=depth), _requests(tgen, [prompt], [frames]))
    eng = _engine("none", pipeline_depth=depth)
    r1, n_before = _preempted(eng, tgen, prompt, frames)
    jeng = _ref_engine("none")
    j1, _ = _preempted(jeng, jgen, prompt, frames)
    assert r1.out == r0.out == list(map(int, j1.out))
    cs = eng.health()["state_counters"]
    assert cs["encoder_launches"] == _encodes(jeng) == 1
    assert cs["state_restores"] == 1 and 0 < cs["replay_tokens"] <= PS
    assert cs["replay_tokens"] < len(prompt) + n_before


def test_host_tier_resume_zero_replay_no_encode():
    """With the host tier the live row comes back verified: zero replay,
    no encode, bit-identical tokens; the reference counts the same."""
    prompt, frames = _prompts(1)[0], _frames(0)
    (r0,) = _serve(_engine("none"), _requests(tgen, [prompt], [frames]))
    eng = _engine("none", host_pages=8)
    r1, _ = _preempted(eng, tgen, prompt, frames)
    jeng = _ref_engine("none", host_pages=8)
    j1, _ = _preempted(jeng, jgen, prompt, frames)
    assert r1.out == r0.out == list(map(int, j1.out))
    cs, sw = eng.health()["state_counters"], eng.health()["swap"]
    assert cs["replay_tokens"] == 0 and cs["encoder_launches"] == _encodes(jeng) == 1
    assert sw["swap_outs"] == sw["verified_swapins"] == 1
    assert sw == jeng.health()["swap"]


def test_forks_share_the_encoder_page():
    """A greedy best-of-2: the siblings share the checkpoint and the
    encoder page by refcount (one encode), and give the same tokens."""
    prompt, frames = _prompts(1)[0], _frames(0)
    eng = _engine("none")
    r = tgen.Request(rid=0, prompt=prompt, max_new=GEN, n_samples=2, frames=frames)
    eng.submit(r)
    eng.step()
    (i, j) = [k for k, s in enumerate(eng.slots) if s.req is not None]
    page = eng.slots[i].enc_page
    assert page == eng.slots[j].enc_page and eng.pool_mgr.refcount[page] == 2
    fin, _ = eng.run_to_completion()
    jeng = _ref_engine("none")
    jeng.submit(jgen.Request(rid=0, prompt=prompt, max_new=GEN, n_samples=2, frames=frames))
    jfin, _ = jeng.run_to_completion()
    assert len(fin) == 2 and fin[0].out == fin[1].out == list(map(int, jfin[0].out))
    assert eng.stats["shared_pages"] == jeng.stats["shared_pages"] == 2
    assert _encodes(eng) == _encodes(jeng) == 1


def test_dropped_prefix_claim_encodes_again():
    """The ``prefix_claim`` seam at the second request's admission drops its
    hit: it encodes into a page of its own (2 launches, as the reference),
    with the same tokens."""
    prompts, frames = _prompts(2), [_frames(0)] * 2
    sched = [(2, "prefix_claim")]  # tick 2: request 1's admission

    def run(gen, eng):
        reqs = _requests(gen, prompts, frames)
        eng.submit(reqs[0])
        eng.step()
        eng.submit(reqs[1])
        eng.run_to_completion()
        return reqs

    eng = _engine("none", fault_injector=tfaults.FaultInjector(seed=0, schedule=sched))
    reqs = run(tgen, eng)
    jeng = _ref_engine("none", fault_injector=jfaults.FaultInjector(seed=0, schedule=sched))
    jreqs = run(jgen, jeng)
    assert _encodes(eng) == _encodes(jeng) == 2
    assert eng.stats["prefix_hits"] == jeng.stats["prefix_hits"] == 0
    assert [r.out for r in reqs] == [list(map(int, r.out)) for r in jreqs]
    # the second encode's page stayed private (the hash was known) and was freed
    assert eng.pool_mgr.used_by_kind()["shared_ro"] == len(eng.prefix.by_hash) == 1


def test_parked_encoder_pages_are_evicted_never_swapped():
    """Requests over 12 distinct frames one after another fill the pool with
    parked encoder pages: the allocator evicts them LRU-first, and with the
    host tier on none is swapped out (a shared_ro page can be encoded
    again; the tier holds state pages).  The first frames, asked again,
    encode again.  The reference counts the same."""
    frames = [_frames(k) for k in range(12)] + [_frames(0)]
    prompt = _prompts(1)[0]

    def run(gen, eng):
        for k, f in enumerate(frames):
            eng.submit(gen.Request(rid=k, prompt=prompt, max_new=2, frames=f))
            eng.run_to_completion()
        return eng

    eng = run(tgen, _engine("none", host_pages=8))
    jeng = run(jgen, _ref_engine("none", host_pages=8))
    n_pages = 1 + 3 * SLOTS + 4
    assert eng.pool_mgr.n_pages == jeng.pool_mgr.n_pages == n_pages
    assert eng.stats["prefix_evictions"] == jeng.stats["prefix_evictions"] > 0
    assert _encodes(eng) == _encodes(jeng) == len(frames)  # the last one encoded again
    assert eng.health()["swap"]["swap_outs"] == 0 and eng.host_tier.used() == 0
    assert eng.health()["swap"] == jeng.health()["swap"]


# -------------------------------------------------------------------- CLI
def test_cli_contiguous_paged_and_chaos(tmp_path, capsys):
    from repro_torch.launch.serve import main

    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--packed", "--batch", "2",
            "--prompt-len", "6", "--gen", "4", "--page-size", "8"]
    main(base)
    assert "contiguous: 8 tokens" in capsys.readouterr().out
    main(base + ["--paged", "--host-tier"])
    out = capsys.readouterr().out
    assert "8 tokens" in out and "(state pages)" in out and "encoder_launches 1" in out
    assert "prefix_hits 1" in out  # the batch shares the stub frames
    report = tmp_path / "chaos.json"
    assert main(base + ["--chaos", "--chaos-seed", "3", "--chaos-rate", "0.2",
                        "--audit-every", "1", "--chaos-report", str(report)]) == 0
    rep = json.loads(report.read_text())
    assert rep["page_layout"] == "state" and rep["final_audit"]["ok"] and not rep["leaked_pages"]
    check = subprocess.run([sys.executable, str(ROOT / "tools" / "check_chaos.py"), str(report)],
                           capture_output=True, text=True)
    assert check.returncode == 0, check.stdout + check.stderr
