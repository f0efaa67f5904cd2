#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; the last line is printed only on
success):

1. device: name, power limit and count; build of the CUDA kernels
   (csrc/*.cu, one nvcc per source) and the ptxas register report.
2. fused W4A4 linear kernel vs its plain PyTorch version at the serving
   shapes of gpt3_126m.
3. page-gather attention kernel (split over the KV pages, then a
   combine) vs its plain version: bf16 / int8 / bcq4 pages, C = 1 and 64,
   d_head 64, 32 and 128 (Moonlight's heads), GQA, NULL-padded tables,
   zero-length rows, rows of up to 40 pages (five splits).
4. serving: full-width gpt3_126m (12 layers, seeded random weights packed
   to W4 by the port's pack_params) through PagedEngine — bcq4 pool,
   page 16, prefill chunk 64, 8 slots, 8 requests of 48–500 prompt
   tokens, 32 new tokens each — once through the kernels on the
   production tick (the decode step as one CUDA graph, pipeline depth 2,
   launches counted per replay) and once through the plain paths eagerly
   at depth 1.  Every kernel must have launched layers ×
   per-layer × forward passes times in the kernel run (the fused linear
   6 a layer, the page gather and the KV-page writer 1) and none in the
   plain run; every writer launch of the first engine step (a prefill
   tick and a decode tick) and of a steady decode tick (8 rows decoding)
   must write the plain writer's page bytes on the inputs that tick gave
   it; the two paths' logits on identical inputs must agree (to rounding
   without W4A4, to twice the plain path's own 1-ulp noise floor with
   it); greedy tokens must agree under the margin rule; then one steady
   decode tick of each path is timed and traced, with the KV page write's
   kernels and device time split out.
5. flash attention kernel vs its plain version: bf16 (tensor cores) and
   f32 (CUDA cores), causal and full, S ∈ {128, 384, 2048, 200}, d_head ∈
   {32, 64, 128}, GQA through the (B, S, H, D) wrapper.
6. quantize kernel vs ``quantize_ref`` at (8192, 768), (8192, 3072) and a
   ragged (37, 192): bytes equal (decoded values equal on a codebook
   tie), ratios exactly equal.  (Its page-store form, the KV writer, is
   held to its plain version in phase 4 and phase 10.)
7. W4A4 matmul kernel vs ``matmul_ref`` at M 8192 × (K, N) ∈ {(768,
   3072), (3072, 768)} and a ragged (37, 192, 100).
8. the two-launch W4A4 GEMM: ``ops.w4a4_linear`` over all 72 packed
   weights of full-width gpt3_126m, each with a seeded (8192, K)
   activation, against ``ops.w4a4_linear_fused``; exactly 72 quantize and
   72 matmul launches; whether the two routes are bit-equal.
9. held-out evaluation: full-width gpt3_126m (seeded random weights
   packed to W4), bf16 compute, ``flash_kernel=True``, on two held-out
   batches of 4 × 2048 tokens — once through the kernels (exactly 12
   flash and 72 fused-linear launches per forward) and once through the
   plain paths; every flash and fused-linear launch of one forward is
   held against its plain version on the inputs the forward gave it;
   the W4A4 losses of the two paths, paired on the original weights and
   on seven copies with the input embedding nudged by one bf16 ulp,
   differ on average by at most twice the plain path's own noise floor
   (its mean |Δloss| under those nudges); with float weights the bf16 losses
   agree to 1e-3 and the f32 hidden states and logits to rounding; loss,
   perplexity, ms per forward, tokens/s and the device idle share of one
   forward.
10. each kernel timed at its main-path shape beside its plain version
    (and held to it there), its bound (W4A4 products at the int8
    tensor-core peak) and its library yardstick — the fused linear at
    decode (M 8) and at the evaluation's mlp-in and mlp-out shapes (M
    8192), with its two device kernels (encode pass, GEMM) split out by
    torch.profiler; the page gather at decode and at a chunked-prefill
    shape; flash in bf16 and its f32 specialisation; quantize at (8192,
    768) and its page-store form, the KV writer, at decode (8 rows) and
    at a prefill chunk (8 × 64 tokens) of 12 heads of 64; each printed
    line names the kernel's time in an earlier run (``EARLIER_MS``).  A
    kernel's device time is the mean of the profiler events it got; a
    window that lost more than half a kernel's events or reads under the
    bound is profiled again, and fails the run the third time.
11. the serving core: full-width gpt3_126m, bcq4, page 16, chunk 64,
    prefix caching on, 8 slots and a 98-page pool; 12 requests of a
    shared 320-token prefix plus 16–150 suffix tokens, submitted at once
    (9 greedy, one greedy forked in 2, one sampled forked in 3 at T 0.8
    and top-k 40, one sampled at T 1.0), 32 tokens each — once through
    the kernels and once through the plain paths.  Tokens agree under the
    margin rule (a sampled token's margin: the logit change that alters
    its draw) and the counters (hits, misses, forks, COW copies,
    preemptions) are equal up to the first differing launch; B1, B2 and
    the KV writer launched layers × per-layer × passes times, none in the
    plain run; at least one preemption and COW copy and some prefill
    tokens skipped; the page accounting clean after the drain (refcounts
    0, every page free or parked, parked == registered); the greedy
    fork's siblings equal; a third kernel run with every launch also
    run through the plain paths on its own inputs (a copy of the pool as
    the launch found it): each launch's logits within twice the noise
    floor, every booked token — sampled rows, forks, resumed requests,
    ticks after a COW copy included — the sampler's pick on its own
    logits and, against the plain logits' pick, equal or a flip under the
    margin rule; a rerun with ``eos_id`` = a greedy request's 8th token
    stops it there and equals the first run up to that launch; every
    fused-linear launch of one slab prefill held to its plain version,
    and 4 requests served through slab admission by both paths agree
    under the margin rule, whole runs and launch by launch.  Prints ms
    per decode tick, prefill tokens/s, the counters and the sampler
    overlay's device time.  Its launches join the ``kernels`` line
    (``serving_core``).  Phase 4's checks of single launches and phase
    11 run the engine eagerly at depth 1.
12. the production tick: phase 4's workload three ways — eager depth 1,
    the decode step as a CUDA graph at depth 1, and at depth 2 — and
    phase 11's two (eager depth 1, its kernel run; graph depth 2), each
    way equal to the first bit for bit: tokens, margins, launch
    indices, engine counters, pool bytes and kernel launch counts.  A
    fresh engine captures one graph per block-table width, a warmed
    engine none; a steady greedy graph tick makes one ``cudaGraphLaunch``
    and no kernel launch from the host.  For each way: wall
    ms/tick of steady ticks (8 rows), device busy, idle share, host
    kernel and graph launches and CUDA kernels a tick (torch.profiler
    over 3 ticks); for phase 11's workload the same over its decode-only
    steps with sampled rows.  Phase 11's graph depth 2 run is held launch
    by launch to the plain paths (``check_shadow``).  Its graph depth 2
    launches join the ``kernels`` line (``production_tick``).
13. containment on the card: phase 11's model, pool and requests plus
    request 3 with ``max_output_stall_ticks`` 7 (preempted, it expires in
    the queue), two more with ``deadline_s`` 0.0 and request 4 cancelled
    mid-decode, under a pinned ``FaultInjector`` schedule that fires every
    non-swap site (a launch delay, a sampler fault on a sampled fork's
    sibling, non-finite logits on a decoding slot, a dropped prefix claim,
    a dry allocator query in a chunk tick) and an audit every 4 ticks —
    through the kernels at graph depth 2 and eagerly at depth 1, and
    through the plain paths eagerly at depth 1.  No exception escapes,
    every request ends clean or with its expected typed error, no page
    stays referenced, the audits are clean; the two kernel ways equal bit
    for bit (tokens, margins, launch indices, error kinds, engine and
    health counters, pool bytes, launch counts), kernels and plain equal
    in error kinds and under the margin rule in tokens, the kernels
    launched layers × per-layer × passes times.  The serving CLI's chaos
    run (``launch.serve.run_chaos`` at its default rate) at graph depth 2
    writes ``build/chaos_report.json``, which ``tools/check_chaos.py``
    must accept, and equals an eager depth 1 rerun.  The default engine
    with an audit every 8 ticks keeps phase 12's steady greedy graph tick
    (kernels a tick, one ``cudaGraphLaunch``, no host kernel launch) and
    its bits; its wall ms/tick is printed beside phase 12's and an earlier run's
    with the card's name and power limit.  Its kernel runs' launches join
    the ``kernels`` line (``containment``).
14. telemetry on the card: phase 11's workload at graph depth 2 with the
    telemetry at its ``"counters"`` level equals phase 12's run (the
    ``"default"`` level: histograms, timelines, journal) bit for bit —
    tokens, margins, launch indices, counters, pool bytes, launch counts —
    with equal ``device_syncs``; that run's TTFT count equals its finished
    requests and its ITL count the tokens after each request's first; its
    metrics and Chrome trace (``build/telemetry_*.json``) pass
    ``tools/check_telemetry.py``.  Phase 4's workload on a counters-level
    engine beside phase 12's default one: the same decode-graph nodes,
    bits and ``device_syncs``, 1 ``cudaGraphLaunch`` and no host kernel
    launch a steady tick, the two walls printed.  The quant-error probes
    (``--quant-probes``: a ``QuantProbeRecorder`` in the model's Runtime):
    phase 11's workload eagerly at depth 1 — every probe launch of B3 held
    to the plain ``encode_stats`` on the same activation (NMSE within
    1e-6, occupancy equal but on codebook ties, each tie checked) — and
    at graph depth 2: the two probe reports equal bit for bit, the tokens
    and pool bytes of phase 12, 48 B3 launches a pass (4 sites × 12
    layers), the metrics with the probe report accepted by the tool; the
    probe engine's graph nodes and steady tick on phase 4's workload; B3's
    probe form (``encode_stats`` at decode, K 768 and 3072) timed.  Its
    runs' launches join the ``kernels`` line (``telemetry``; B3's probe
    launches as ``probes``, its probe form as ``probe_form``).
15. the host page tier on the card: phase 11's engine with 32 host pages
    (``host_pages``) over phase 11's requests, then 6 unrelated 224-token
    prompts whose pages push the shared prefix's parked pages out to the
    tier, then the shared prefix again thrice (host prefix hits); one
    preempted request is carried to host and resumed from it without a
    prefill; the tier's own LRU eviction fires.  Through the kernels at
    graph depth 2 — every swap-in's page bytes held to those fetched at
    its swap-out, each swap's copies (CUDA events) and host work (digest +
    put, take + verify) timed — and eagerly at depth 1: the two equal bit
    for bit (tokens, margins, launch indices, counters, swap counters, the
    tier's snapshot, pool bytes, launch counts).  Every launch of a graph
    depth 2 run held to the plain paths (``check_shadow``), the first
    decode launch after the resume among them.  A pinned ``swap_corrupt``
    on the resume quarantines that request alone (every request's tokens
    before that launch equal the clean run's); a pinned ``swap_out`` on
    the carry makes the request recompute.  Audits strict and clean, the
    cross-tier partition included.  The CLI's chaos run with the tier
    (seed 1) passes ``tools/check_chaos.py`` and equals an eager depth 1
    rerun.  An idle tier keeps phase 12's steady graph tick (nodes, one
    ``cudaGraphLaunch``, no host kernel launch).  On a bf16 pool at full
    width, every page the ladder recompresses equals the CPU's
    ``_fake_quant`` of its bytes.  The resumed request's re-admission time
    beside its recompute in phase 12's tier-off run; one page's swap
    timed on an idle stream beside the copy's bound at 64 GB/s.  Its
    kernel runs' launches join the ``kernels`` line (``host_tier``).
16. the MoE family: full-width, full-depth Moonlight-16B-A3B
    (``moonshot_v1_16b``: 48 layers, d 2048, 16 heads of 128, 64 experts
    top-6 of d_ff 1408, vocab 163840; seeded random weights drawn and
    packed to W4 one layer at a time on the card, ~17 GB of packed
    experts) with phase 4's settings and requests: the stacked fused
    linear (one launch for a layer's 64 experts of wi, wg or wo) bit for
    bit equal to its per-expert launches and held to its plain version at
    decode, chunk and ragged shapes; the production tick (graph depth 2)
    and eager depth 1 equal bit for bit; launches exactly 3 × 48 stacked
    B1, 4 × 48 dense B1, 48 B2 and 48 writer launches a pass; every launch
    of the first engine step and of a steady decode tick held to its plain
    version on its own inputs (B2 at d_head 128); at 4 layers of the same
    width the kernel run (graph depth 2) and the plain run (eager depth 1)
    agree under the margin rule (the plain expert path at 48 layers would
    cost minutes), and every launch of a graph depth 2 run of phase 11's
    workload at 4 layers is held to the plain paths (``check_shadow``);
    the steady tick's wall and device ms and graph nodes,
    the stacked launch's device ms beside its bound, prefill tokens/s and
    the phase's seconds.  Its launches join the ``kernels`` line (``moe``;
    the stacked form as ``bcq_linear_experts``).
17. the PTQ deploy step on full-width gpt3_126m: seeded float weights
    saved by the port's ``CheckpointManager`` (async writer) and restored
    bit for bit; ``python -m repro_torch.launch.quantize``'s ``main`` on
    the card (calibration on one batch of 4 × 128 tokens, 15 LO-BCQ
    iterations; ``codebooks.json``, the fake and packed npz, the
    manifest; its 6 B3 launches of ``quantize_params``, held to the plain
    encode in a second run); the fit twice, byte-equal to each other and
    to the CLI's books, its history non-increasing, its books equal to the
    port's CPU fit of the same samples; the held-out loss of phase 9's
    batches (bf16, flash kernel) for the fake artifact under every
    act_format, for ``fake_full`` and for the packed artifact, launch counts
    per forward, every B3 launch of a fake and a fake_full forward and
    every B1 / B5 launch of a packed forward held to plain; both artifacts
    served on phase 4's settings and prompts, graph depth 2 ≡ eager depth
    1 bit for bit, exact launches a pass (fake: 4 B3, B2, writer a layer;
    packed: 6 B1, B2, writer), every launch of a prefill and a steady tick
    held to plain; B3's fake-quant form timed.  Its launches join the
    ``kernels`` line (``ptq``; B3's as ``ptq_fake_quant``).
    Then the ``kernels`` JSON line
    (launches, error, times, bound), the card's name and power limit, and
    the device line as the last line.

Needs the repository's ``src/`` beside it: run alone, it fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense), stated at the 700 W limit:
# HBM3 bytes/s; f32 FLOP/s on the CUDA cores (the LO-BCQ encode's compares
# and sums have no tensor-core form); bf16 FLOP/s on the tensor cores (the
# least time for attention over bf16 inputs); int8 OP/s on the tensor cores
# (the least time for a W4A4 product: both operands decode to INT6
# codewords times a scale per 64-wide array, so an int8 MMA per array with
# an f32 rescale computes the same function).
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
W4A4_PEAKS = "int8 tensor cores 1979 TOP/s (product), f32 67 TFLOP/s (encode)"

LINEAR_TOL = 1e-5  # rtol, and atol as a multiple of max|plain| (f32 sum order)
GATHER_TOL = 2e-5  # atol = rtol, as tests/test_paged_kernel.py
FLASH_TOL = {"float32": 2e-4, "bfloat16": 1e-2}  # atol = rtol: tests/test_flash_kernel.py;
# bf16 output rounding of two f32 sums taken in different orders

EVAL_SEQ, EVAL_BATCH, EVAL_BATCHES = 2048, 4, 2  # GPT-3's context length

# Each kernel's time at its main-path shape in an earlier run of this
# script on an NVIDIA H100 80GB HBM3 at 700 W (the bracketed times of
# PERF.md's kernel table), printed beside this run's; B3 by its device
# time (torch.profiler), the others by their event-loop time.
EARLIER_MS = {"bcq_linear": {(8, 768, 3072): 0.0538, (8192, 768, 3072): 0.2431,
                          (8192, 3072, 768): 0.2829},
           "page_gather": 0.0486, "flash_attention": 0.1578, "bcq_quantize": 0.0214,
           "bcq_matmul": 0.2668}


def fail(msg: str) -> None:
    # on both streams: a caller that keeps only the end of one still sees why
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def held(got, ref, rtol, atol):
    """(ok, max|err|): finite ``got`` within atol + rtol·|ref| of ``ref``."""
    err = (got.float() - ref.float()).abs()
    ok = bool(got.float().isfinite().all()) and bool((err <= atol + rtol * ref.float().abs()).all())
    return ok, float(err.max())


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 2
def linear_case(m, k, n, seed, cb):
    """Seeded activation (with a few outlier channels) and packed weight."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    x[:, :: max(1, k // 8)] *= 12.0
    w = torch.randn((n, k), generator=g) * k**-0.5
    enc = bcq.encode(w.cuda(), cb, bcq.BCQConfig())
    pk = {"idx": enc.packed_idx, "sel": enc.packed_sel, "scale": enc.scale_code, "s_x": enc.s_x}
    return x.cuda(), ops.packed_operand(pk)


def phase_linear(cb):
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_linear as bl
    from repro_torch.kernels.ref import fused_linear_ref

    cfg = bcq.BCQConfig()
    worst = 0.0
    cases = [(m, k, n) for m in (8, 256) for k, n in ((768, 768), (768, 3072), (3072, 768))]
    cases.append((37, 192, 100))  # ragged M and N
    for i, (m, k, n) in enumerate(cases):
        x, w = linear_case(m, k, n, i, cb)
        s_x = bcq.tensor_scale(x, cfg)
        got = bl.bcq_linear(x, w.idx_packed, w.sel_packed, w.inv_scale, cb, s_x, cfg)
        ref = fused_linear_ref(x, w.idx_packed, w.sel_packed, w.inv_scale, cb, cfg, s_x, valid_k=k)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        bound = LINEAR_TOL * ref.abs().max() + LINEAR_TOL * ref.abs()
        ok = bool((err <= bound).all())
        rel = float(err.max() / ref.abs().max())
        worst = max(worst, float(err.max()))
        print(f"linear M={m:4d} K={k:4d} N={n:4d}: max|err| {float(err.max()):.3e} "
              f"(max|err|/max|plain| {rel:.2e}, tol rtol={LINEAR_TOL} atol={LINEAR_TOL}·max|plain|) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"fused linear disagrees with its plain version at M={m} K={k} N={n}")
    return worst


# ------------------------------------------------------------------ phase 3
def gather_pool(kind, n_pages, ps, hkv, d, seed, cb):
    """A single-layer page pool with every page written from seeded K/V."""
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.models import layers

    cfg = BCQConfig()
    pool = layers.cache_init(n_pages, ps, hkv, d, kind, cfg, device="cuda")
    g = torch.Generator().manual_seed(seed)
    k = torch.randn((n_pages, ps, hkv, d), generator=g).cuda()
    v = torch.randn((n_pages, ps, hkv, d), generator=g).cuda()
    enc = layers.cache_encode(k, v, kind, cfg, cb, pool)
    for name, val in enc.items():
        pool[name].copy_(val)
    return pool


def gather_case(b, maxp, ps, kv_len, seed, n_pages):
    """Block tables with live pages drawn at random and NULL padding."""
    import torch

    g = torch.Generator().manual_seed(seed)
    bt = torch.randint(1, n_pages, (b, maxp), generator=g, dtype=torch.int32)
    for r, n in enumerate(kv_len):
        bt[r, -(-n // ps):] = 0  # NULL past the live pages
    return bt.cuda(), torch.tensor(kv_len, dtype=torch.int32).cuda()


def phase_gather(cb):
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.kernels import common

    cfg = BCQConfig()
    worst = 0.0
    ps, maxp, n_pages = 16, 40, 97
    for kind in ("bf16", "int8", "bcq4"):
        for d, h, hkv in ((64, 12, 12), (32, 4, 2), (128, 16, 16)):
            pool = gather_pool(kind, n_pages, ps, hkv, d, 1, cb)
            for c in (1, 64):
                # zero-length row, a page boundary, mid-page, near-full
                kv_len = [0, ps, 3 * ps + 5, maxp * ps - 3] if c == 1 else [c, 2 * ps + c, 300, maxp * ps]
                if c > 1:
                    kv_len[0] = 0  # zero-length row under a full chunk
                bt, kvl = gather_case(4, maxp, ps, kv_len, 2, n_pages)
                q = torch.randn((4, c, h, d), generator=torch.Generator().manual_seed(3)).cuda()
                got = common.page_gather_attention(q, pool, bt, kvl, kind, cfg, cb)
                ref = common.page_gather_attention_plain(q, pool, bt, kvl, kind, cfg, cb)
                torch.cuda.synchronize()
                err = (got - ref).abs()
                ok = bool(torch.isfinite(got).all()) and bool(
                    (err <= GATHER_TOL + GATHER_TOL * ref.abs()).all()
                )
                worst = max(worst, float(err.max()))
                print(f"page_gather {kind:4s} C={c:2d} D={d} H={h} Hkv={hkv} kv_len={kv_len}: "
                      f"max|err| {float(err.max()):.3e} (tol atol=rtol={GATHER_TOL}) "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"page_gather disagrees with its plain version ({kind}, C={c}, D={d})")
    return worst


# ------------------------------------------------------------------ phase 4
PROMPT_LENS = [48, 112, 177, 241, 306, 370, 435, 500]
GEN = 32


def run_serving(cfg, kernels: bool, prompts):
    """The kernel run serves through ``serve``'s defaults, the production
    tick (the decode step as a CUDA graph, depth 2: its launch counts are
    counted per replay); the plain run eagerly at depth 1."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve

    mode = {} if kernels else {"pipeline_depth": 1, "cuda_graphs": False}
    build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finished, eng = serve(cfg, prompts, GEN, cache="bcq4", packed=True, page_size=16,
                          prefill_chunk=64, device="cuda", seed=0, kernels=kernels,
                          chunked_prefill=True, prefix_caching=False, **mode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.counts()
    st = eng.stats
    label = (f"kernels, graph depth {eng.pipeline_depth}" if kernels
             else "plain, eager depth 1")
    print(f"serving [{label}]: {wall:.2f}s wall (incl. weight init/pack), "
          f"decode {1e3 * st['t_decode_s'] / max(st['decode_ticks'], 1):.2f} ms/tick over "
          f"{st['decode_ticks']} ticks, prefill {st['prefill_tokens'] / max(st['t_prefill_s'], 1e-9):.0f} "
          f"tok/s over {st['prefill_launches']} launches, launches {counts}", flush=True)
    return finished, eng, counts


def phase_serving():
    from repro_torch.configs.base import get_arch
    from repro_torch.serving.generate import greedy_agreement

    cfg = get_arch("gpt3_126m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    fin_k, eng_k, counts = run_serving(cfg, True, prompts)
    fin_p, eng_p, counts_p = run_serving(cfg, False, prompts)
    for fin in (fin_k, fin_p):
        if sorted(r.rid for r in fin) != list(range(len(prompts))):
            fail("serving did not finish every request")
        for r in fin:
            if len(r.out) != GEN or not all(0 <= t < cfg.vocab_padded for t in r.out):
                fail(f"request {r.rid}: {len(r.out)} tokens, expected {GEN} in [0, vocab)")
    passes = eng_k.stats["decode_ticks"] + eng_k.stats["prefill_launches"]
    expect = {"bcq_linear": cfg.n_layers * 6 * passes, "page_gather": cfg.n_layers * passes,
              "bcq_page_write": cfg.n_layers * passes}
    for name, n in expect.items():
        if counts.get(name, 0) != n or n == 0:
            fail(f"{name} launched {counts.get(name, 0)} times in the kernel run, expected {n}")
        if counts_p.get(name, 0):
            fail(f"{name} launched in the plain run")
    print(f"launch counts match layers × per-layer × passes: {expect} "
          f"({cfg.n_layers} layers, {passes} forward passes)", flush=True)
    cb = eng_k.params["codebooks"]
    err_w = check_write_launches(eng_k, prompts, cb)
    tol = phase_logits(eng_k, eng_p, prompts, [r.out[0] for r in sorted(fin_p, key=lambda r: r.rid)])
    agree = greedy_agreement({r.rid: r for r in fin_p}, {r.rid: r for r in fin_k}, tol)
    margins = np.concatenate([r.margins for r in fin_p])
    print(f"greedy tokens kernels vs plain (margin rule, logit tol {tol:.3e} = the noise "
          f"floor): {agree}; plain-run top-2 margins min {margins.min():.4f} "
          f"median {np.median(margins):.4f}", flush=True)
    err_w += profile_decode(eng_k, prompts, "kernels", cb)
    profile_decode(eng_p, prompts, "plain", cb)
    if not agree["ok"]:
        fail("greedy tokens of the kernel run and the plain run disagree beyond the margin rule")
    return eng_k, counts, err_w, tol


def _fresh_engine(eng_done, prompts):
    """A new engine on ``eng_done``'s model with every prompt submitted,
    eager at depth 1 (the checks that wrap the layers' functions need the
    eager step)."""
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.generate import Request

    eng = PagedEngine(eng_done.api, eng_done.params, n_slots=len(prompts),
                      max_len=eng_done.max_len, page_size=16, prefill_chunk=64,
                      chunked_prefill=True, prefix_caching=False, device="cuda",
                      pipeline_depth=1, cuda_graphs=False)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=GEN - 1))
    return eng


def _pool_diff(got: dict, want: dict, cb) -> int:
    """Differing bytes of two single-layer bcq4 pools, or -1 where they
    disagree: the scale bytes must be equal, idx/sel bytes may differ only
    on a codebook tie (equal decoded values)."""
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.models.layers import cache_read

    n = sum(int((got[k] != want[k]).sum()) for k in got if got[k].ndim >= 2)
    if n == 0:
        return 0
    if not all(torch.equal(got[f"{s}_scale"], want[f"{s}_scale"]) for s in "kv"):
        return -1
    a, b = (cache_read(p, "bcq4", BCQConfig(), cb, torch.float32) for p in (got, want))
    return n if all(torch.equal(x, y) for x, y in zip(a, b)) else -1


def capture_writes(eng):
    """Step ``eng`` once with every KV page write it makes
    (``layers.paged_token_write`` / ``paged_chunk_write``, one a layer and
    pass) captured: the write's function name, copies of its pool before
    and after, and its arguments."""
    import torch

    from repro_torch.models import layers

    real = {n: getattr(layers, n) for n in ("paged_token_write", "paged_chunk_write")}
    calls = []

    def capture(name):
        def write(pool, *args, **kw):
            before = {n: t.clone() for n, t in pool.items()}
            out = real[name](pool, *args, **kw)
            calls.append((name, before, {n: t.clone() for n, t in out.items()},
                          [a.clone() if torch.is_tensor(a) else a for a in args], kw))
            return out
        return write

    for name in real:
        setattr(layers, name, capture(name))
    try:
        eng.step()
    finally:
        for name, fn in real.items():
            setattr(layers, name, fn)
    return calls


def hold_writes(calls, cb, what):
    """Each captured write replayed by the plain writer (``kernel=False``)
    on a copy of its pool before the write, and compared byte for byte
    with the pool the step left.  Returns the differing bytes (0 unless a
    codebook tie)."""
    from repro_torch.models import layers

    diff = 0
    for name, before, after, args, kw in calls:
        plain = {n: t.clone() for n, t in before.items()}
        getattr(layers, name)(plain, *args, **dict(kw, kernel=False))
        n = _pool_diff(after, plain, cb)
        if n < 0:
            fail(f"the KV-page writer disagrees with the plain writer on a {what} write "
                 f"({name}, k {tuple(args[0].shape)} {args[0].dtype})")
        diff += n
    return diff


def check_write_launches(eng_done, prompts, cb):
    """Hold every KV-page writer launch of one engine step — its prefill
    tick (a chunk of every prompt) and its decode tick — against the plain
    writer on the very inputs the step gave it (``hold_writes``).  The
    launches of this check are not counted toward the main path's."""
    calls = capture_writes(_fresh_engine(eng_done, prompts))
    n_layers = eng_done.api.cfg.n_layers
    kinds = [sum(c[0] == n for c in calls) for n in ("paged_chunk_write", "paged_token_write")]
    if kinds != [n_layers, n_layers]:
        fail(f"one engine step made {kinds} prefill and decode writes, expected {n_layers} each")
    diff = hold_writes(calls, cb, "first-step")
    print(f"every KV-page writer launch of one prefill tick and one decode tick vs the plain "
          f"writer on its own inputs: {n_layers} + {n_layers} launches, page bytes equal "
          f"({diff} differing idx/sel bytes, all codebook ties)", flush=True)
    return diff


def _forward_logits(api, params, prompts, tokens):
    """Prefill + decode logits of one forward each, staged as the engine
    stages them: one chunked-prefill launch of every request's first whole
    pages (up to 64 tokens), then one decode launch feeding ``tokens``."""
    import torch

    ps, b = 16, len(prompts)
    c = min(64, min(len(p) for p in prompts) // ps * ps)
    n_cp = c // ps
    tables = torch.zeros((b, n_cp + 1), dtype=torch.int32)
    tables[:] = torch.arange(1, (n_cp + 1) * b + 1, dtype=torch.int32).reshape(b, -1)
    chunk = torch.tensor(np.stack([p[:c] for p in prompts]), dtype=torch.int32)
    full = torch.full((b,), c, dtype=torch.int32)
    pool = api.pool_init(1 + (n_cp + 1) * b, ps)
    lp, pool = api.prefill_from_pages_fn(
        params, chunk.cuda(), pool, tables.cuda(), torch.zeros(b, dtype=torch.int32).cuda(),
        tables[:, :n_cp].cuda(), chunk_len=full.cuda())
    tok = torch.tensor([[t] for t in tokens], dtype=torch.int32)
    ld, _ = api.paged_decode_fn(params, pool, tok.cuda(), tables.cuda(), full.cuda())
    return torch.cat([lp.float(), ld.float()], dim=1)  # (B, 2, V)


def _compare(name, a, b):
    d = (a - b).abs()
    out = {"max": float(d.max()), "rms": float(d.pow(2).mean().sqrt()),
           "scale": float(b.abs().max()),
           "top1": float((a.argmax(-1) == b.argmax(-1)).float().mean())}
    print(f"logits {name}: max|Δ| {out['max']:.3e}, rms Δ {out['rms']:.3e} "
          f"(max|logit| {out['scale']:.3f}), top-1 agreement {out['top1']:.3f}", flush=True)
    return out


def phase_logits(eng_k, eng_p, prompts, tokens):
    """End-to-end logits of the kernel path against the plain path on
    identical inputs at full width, held to two yardsticks:

    * without W4A4 (float weights, bf16 pages — only the page-gather
      kernel differs) they must agree to rounding: max|Δ| ≤ 1e-3 ·
      max|logit| (f32 summation order, and a K/V value at a bf16 rounding
      boundary moving by one bf16 ulp, 2^-8, in the next layer's page);
    * with W4A4 the paths round differently and the 4-bit encode turns a
      last-bit difference into a quantization step wherever an activation
      sits at a threshold, so they agree to quantization noise.  The noise
      floor is the plain path against itself with the embedding scaled by
      1 + 2^-22 (one ulp); the kernel path may differ from the plain path
      by at most twice that (max and rms).

    Returns the noise floor's max|Δ|: the margin rule's tolerance."""
    import torch

    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    cfg = eng_k.api.cfg
    kp = _compare("kernels vs plain, W4A4 + bcq4",
                  _forward_logits(eng_k.api, eng_k.params, prompts, tokens),
                  _forward_logits(eng_p.api, eng_k.params, prompts, tokens))
    nudged = dict(eng_k.params, embed={"kernel": eng_k.params["embed"]["kernel"] * (1 + 2**-22)})
    floor = _compare("plain vs plain with a 1-ulp embedding nudge (noise floor)",
                     _forward_logits(eng_p.api, nudged, prompts, tokens),
                     _forward_logits(eng_p.api, eng_k.params, prompts, tokens))
    if kp["max"] > 2 * floor["max"] or kp["rms"] > 2 * floor["rms"]:
        fail(f"kernel path differs from the plain path ({kp}) beyond twice the plain "
             f"path's own 1-ulp noise floor ({floor})")
    apis = [zoo.build(cfg, Runtime(quant_mode="none", compute_dtype=torch.float32,
                                   cache_kind="bf16", paged_kernel=k), device="cuda")
            for k in (True, False)]
    params = apis[0].init(0)
    fl = _compare("kernels vs plain, float weights + bf16 pages",
                  _forward_logits(apis[0], params, prompts, tokens),
                  _forward_logits(apis[1], params, prompts, tokens))
    if fl["max"] > 1e-3 * fl["scale"]:
        fail(f"without W4A4 the kernel path must agree to rounding: {fl}")
    return floor["max"]


def _device_kernels(fn, n=1):
    """(CUDA kernels, device ms, device ms by kernel name) per call of
    ``fn`` over ``n`` profiled calls, and the events seen of each name; or
    None where the profiler saw no device kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    by_name, seen = {}, {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / n / 1e3
        seen[e.name] = seen.get(e.name, 0) + 1
    return len(kern) / n, sum(by_name.values()), by_name, seen


def kv_write_split(eng, cb):
    """The KV page write of one decode tick on its own: the tick's writes
    (one a layer) are captured, held to the plain writer
    (``hold_writes``), then replayed on their pools under torch.profiler.
    Returns ((CUDA kernels, device ms) per tick, or None; differing
    bytes)."""
    import torch

    from repro_torch.models import layers

    calls = capture_writes(eng)
    if [c[0] for c in calls] != ["paged_token_write"] * eng.api.cfg.n_layers:
        fail(f"a steady decode tick made the writes {[c[0] for c in calls]}, expected "
             f"{eng.api.cfg.n_layers} decode writes")
    diff = hold_writes(calls, cb, "steady decode")

    def replay():
        for name, before, _, args, kw in calls:
            getattr(layers, name)(before, *args, **kw)

    replay()
    torch.cuda.synchronize()
    got = _device_kernels(replay)
    return (None if got is None else got[:2]), diff


def profile_decode(eng_done, prompts, label, cb):
    """Where a steady decode tick's time goes: a fresh engine on the same
    model is stepped until every request decodes, then 3 ticks are timed
    (host clock, synchronized), 3 more traced with torch.profiler, and the
    KV page write of one more tick held to the plain writer and split out
    (``kv_write_split``).  Returns that tick's differing page bytes."""
    import torch

    eng = _fresh_engine(eng_done, prompts)
    while eng.queue or any(s.mode == "prefill" for s in eng.slots if s.req is not None):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    prof = _device_kernels(eng.step, 3)
    kv, diff = kv_write_split(eng, cb)
    kv_txt = ("the profiler saw no device kernels" if kv is None else
              f"{kv[0]:.0f} CUDA kernels/tick, device {kv[1]:.3f} ms/tick")
    kv_txt += f"; page bytes equal to the plain writer's ({diff} differing, codebook ties)"
    if prof is None:
        print(f"decode tick profile [{label}]: wall {wall:.2f} ms/tick; the profiler saw no "
              f"device kernels (device time not measured); KV page write: {kv_txt}", flush=True)
        return diff
    n_kern, busy, by_name, _ = prof
    print(f"decode tick profile [{label}] (8 rows decoding): wall {wall:.2f} ms/tick unprofiled, "
          f"{n_kern:.0f} CUDA kernels/tick, device busy {busy:.2f} ms/tick (idle share "
          f"{max(0.0, 1 - busy / wall):.3f}); of it the KV page write "
          f"({eng.api.cfg.n_layers} layers, replayed): "
          f"{kv_txt}", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:8.3f} ms/tick  {name[:90]}", flush=True)
    return diff


# ------------------------------------------------------------------ phase 5
def phase_flash():
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import _attend_chunked

    worst = {}
    g = torch.Generator(device="cuda").manual_seed(11)
    for dtype in (torch.bfloat16, torch.float32):
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        worst[dtype] = 0.0
        for causal in (True, False):
            for s_len in (128, 384, 2048, 200):
                for d in (32, 64, 128):
                    q, k, v = (torch.randn((4, s_len, d), generator=g, device="cuda").to(dtype)
                               for _ in range(3))
                    got = fa.flash_attention_kernel(q, k, v, causal)
                    ref = fa.flash_attention_plain(q, k, v, causal)
                    torch.cuda.synchronize()
                    err = (got.float() - ref.float()).abs()
                    ok = got.dtype == dtype and bool(torch.isfinite(got.float()).all()) and bool(
                        (err <= tol + tol * ref.float().abs()).all())
                    worst[dtype] = max(worst[dtype], float(err.max()))
                    if not ok:
                        fail(f"flash attention disagrees with its plain version ({dtype}, "
                             f"causal={causal}, S={s_len}, D={d}): max|err| {float(err.max()):.3e}")
        print(f"flash {str(dtype):14s}: 24 cases (causal/full × S 128/384/2048/200 × D 32/64/128) "
              f"ok, max|err| {worst[dtype]:.3e} (tol atol=rtol={tol})", flush=True)
    # GQA through the (B, S, H, D) wrapper, against the model's masked softmax
    q = torch.randn((2, 384, 12, 64), generator=g, device="cuda")
    k, v = (torch.randn((2, 384, 4, 64), generator=g, device="cuda") for _ in range(2))
    got = fa.flash_attention(q, k, v)
    ref = _attend_chunked(q, k, v, torch.arange(384, device="cuda")[None].expand(2, 384), 384)
    err = float((got - ref).abs().max())
    print(f"flash GQA wrapper H=12 Hkv=4 S=384: max|err| {err:.3e} (tol 2e-4)", flush=True)
    if not torch.allclose(got, ref, rtol=2e-4, atol=2e-4):
        fail("flash GQA wrapper disagrees with the masked softmax")
    return max(*worst.values(), err)


# ------------------------------------------------------------- phases 6, 7
def activation(m, k, seed):
    """A seeded (m, k) activation with LLM-like outlier channels, on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    x[:, :: max(1, k // 8)] *= 12.0
    return x


def phase_quantize(cb):
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_quantize as bq
    from repro_torch.kernels.ref import decode_ref, quantize_ref

    cfg = bcq.BCQConfig()
    worst = 0.0
    for i, (m, k) in enumerate(((8192, 768), (8192, 3072), (37, 192))):
        x = activation(m, k, 20 + i)
        s_x = bcq.tensor_scale(x, cfg)
        idx, sel, ratio = bq.bcq_quantize(x, cb, s_x, cfg)
        r_idx, r_sel, r_ratio = quantize_ref(x, cb, cfg, s_x)
        torch.cuda.synchronize()
        if not torch.equal(ratio, r_ratio):
            fail(f"quantize ratios differ at ({m}, {k})")
        inv = torch.ones_like(r_ratio) / (r_ratio * s_x)
        got, ref = decode_ref(idx, sel, inv, cb, cfg), decode_ref(r_idx, r_sel, inv, cb, cfg)
        n_diff = int((idx != r_idx).sum() + (sel != r_sel).sum())
        worst = max(worst, float((got - ref).abs().max()))
        print(f"quantize ({m}, {k}): ratios equal, {n_diff} differing idx/sel bytes, "
              f"decoded values {'equal' if torch.equal(got, ref) else 'DIFFER'}", flush=True)
        if not torch.equal(got, ref):
            fail(f"quantize decoded values differ at ({m}, {k})")
    return worst


def phase_matmul(cb):
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_matmul as bm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref

    cfg = bcq.BCQConfig()
    worst = 0.0
    for i, (m, k, n) in enumerate(((8192, 768, 3072), (8192, 3072, 768), (37, 192, 100))):
        a = ops.quantize(activation(m, k, 30 + i), cb, cfg)
        _, w = linear_case(8, k, n, 40 + i, cb)
        args = (a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed, w.sel_packed,
                w.inv_scale, cb, cb, cfg)
        got, ref = bm.bcq_matmul(*args), matmul_ref(*args)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        ok = bool((err <= LINEAR_TOL * ref.abs().max() + LINEAR_TOL * ref.abs()).all())
        worst = max(worst, float(err.max()))
        print(f"matmul M={m:4d} K={k:4d} N={n:4d}: max|err| {float(err.max()):.3e} "
              f"(max|err|/max|plain| {float(err.max() / ref.abs().max()):.2e}, tol rtol="
              f"{LINEAR_TOL} atol={LINEAR_TOL}·max|plain|) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"W4A4 matmul disagrees with its plain version at M={m} K={k} N={n}")
    return worst


# ------------------------------------------------------------------ phase 8
def packed_weights(params, cfg):
    """The 72 packed GEMM weights of a packed gpt3_126m tree, as
    (name, PackedOperand) per layer."""
    from repro_torch.kernels import ops

    out = []
    for i in range(cfg.n_layers):
        for blk, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wo"))):
            for nm in names:
                pk = {k: v[i] for k, v in params["layers"][blk][nm]["kernel_packed"].items()}
                out.append((f"{i}.{blk}.{nm}", ops.packed_operand(pk)))
    return out


def phase_two_launch(cb):
    """The two-launch W4A4 GEMM over every packed weight of full-width
    gpt3_126m: the main path of ops.w4a4_linear."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core.bcq import BCQConfig
    from repro_torch.kernels import build, ops
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    cfg = get_arch("gpt3_126m")
    params = zoo.build(cfg, Runtime(quant_mode="packed"), device="cuda").init(0)
    weights = packed_weights(params, cfg)
    bcfg = BCQConfig()
    worst, worst_rel, n_equal = 0.0, 0.0, 0
    build.reset_counts()
    for i, (name, w) in enumerate(weights):
        x = activation(EVAL_SEQ * EVAL_BATCH, w.k, 100 + i)
        got = ops.w4a4_linear(x, w, cb, bcfg)
        ref = ops.w4a4_linear_fused(x, w, cb, bcfg)  # launches bcq_linear, not counted here
        err = (got - ref).abs()
        n_equal += bool(torch.equal(got, ref))
        worst, worst_rel = max(worst, float(err.max())), max(worst_rel, float(err.max() / ref.abs().max()))
        if not bool((err <= LINEAR_TOL * ref.abs().max() + LINEAR_TOL * ref.abs()).all()):
            fail(f"two-launch linear disagrees with the fused linear on weight {name}")
    counts = {n: build.counts().get(n, 0) for n in ("bcq_quantize", "bcq_matmul")}
    print(f"two-launch vs fused W4A4 linear over {len(weights)} weights at M={EVAL_SEQ * EVAL_BATCH}: "
          f"max|err| {worst:.3e}, max|err|/max|fused| {worst_rel:.2e} (tol rtol={LINEAR_TOL} "
          f"atol={LINEAR_TOL}·max|fused|) ok; bit-equal on {n_equal} of {len(weights)} weights; "
          f"launches {counts}", flush=True)
    for name in ("bcq_quantize", "bcq_matmul"):
        if counts.get(name, 0) != len(weights):
            fail(f"{name} launched {counts.get(name, 0)} times, expected {len(weights)}")
    return counts, worst


# ------------------------------------------------------------------ phase 9
def _eval_losses(api, params, batches):
    """The held-out loss of each batch, and the host ms of each forward."""
    import torch

    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(api.loss_fn(params, b)))
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, ms


def phase_eval():
    """Held-out W4A4 evaluation of full-width gpt3_126m: the forward of
    ``launch/train.py``'s eval loss and of ``benchmarks/table2_ppl.py``."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, eval_stream
    from repro_torch.kernels import build
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.models.transformer import forward_hidden, lm_logits

    cfg = get_arch("gpt3_126m")
    dc = DataConfig(vocab=cfg.vocab, seq_len=EVAL_SEQ, global_batch=EVAL_BATCH)
    batches = list(eval_stream(dc, EVAL_BATCHES, device="cuda"))
    toks = EVAL_SEQ * EVAL_BATCH
    rt_k = Runtime(quant_mode="packed", compute_dtype=torch.bfloat16, flash_kernel=True)
    rt_p = dataclasses.replace(rt_k, flash_kernel=False, fused_linear=False)
    api_k, api_p = (zoo.build(cfg, rt, device="cuda") for rt in (rt_k, rt_p))
    params = api_k.init(0)

    build.reset_counts()
    loss_k, ms_k = _eval_losses(api_k, params, batches)
    counts = build.counts()
    build.reset_counts()
    loss_p, ms_p = _eval_losses(api_p, params, batches)
    counts_p = build.counts()
    expect = {"flash_attention": cfg.n_layers * EVAL_BATCHES,
              "bcq_linear": cfg.n_layers * 6 * EVAL_BATCHES}
    for name, n in expect.items():
        if counts.get(name, 0) != n:
            fail(f"{name} launched {counts.get(name, 0)} times in the evaluation, expected {n}")
    if any(counts_p.values()):
        fail(f"kernels launched in the plain evaluation run: {counts_p}")
    mean_k, mean_p = sum(loss_k) / len(loss_k), sum(loss_p) / len(loss_p)
    for nm, losses, ms in (("kernels", loss_k, ms_k), ("plain  ", loss_p, ms_p)):
        if not all(math.isfinite(x) for x in losses):
            fail(f"non-finite evaluation loss through the {nm.strip()}: {losses}")
        print(f"eval W4A4 [{nm}]: loss {sum(losses) / len(losses):.6f} (per batch "
              f"{', '.join(f'{x:.6f}' for x in losses)}), ppl {math.exp(sum(losses) / len(losses)):.2f}, "
              f"{ms[-1]:.1f} ms/forward ({toks / ms[-1] * 1e3:.0f} tokens/s; first {ms[0]:.1f} ms)",
              flush=True)
    print(f"launch counts match layers × per-layer × forwards: {expect} "
          f"({EVAL_BATCHES} forwards of {EVAL_BATCH} × {EVAL_SEQ} tokens)", flush=True)

    err_in = check_eval_launches(api_k, params, batches[0])

    gate = w4a4_gate(api_k, api_p, params, batches, mean_k, mean_p)
    if not gate["gap"] <= 2 * gate["floor"]:
        fail(f"W4A4 evaluation loss of the kernels differs from the plain path's by "
             f"{gate['gap']:.3e} (paired over {NUDGES + 1} inputs), beyond twice the plain "
             f"path's own noise floor {gate['floor']:.3e}")

    # float weights: only the flash kernel differs.  In bf16 compute the
    # losses agree to 1e-3 (bf16 rounding of attention outputs); in f32
    # compute the final hidden states and the logits of every 64th position
    # agree to rounding, max|Δ| ≤ 1e-3 · max|plain| as phase 4's yardstick
    def float_model(dt):
        rt = Runtime(quant_mode="none", compute_dtype=dt, flash_kernel=True)
        api_fk, api_fp = (zoo.build(cfg, r, device="cuda")
                          for r in (rt, dataclasses.replace(rt, flash_kernel=False)))
        build.reset_counts()
        return api_fk, api_fp, api_fk.init(0)

    def flash_launched():
        if build.counts().get("flash_attention", 0) != cfg.n_layers * EVAL_BATCHES:
            fail(f"flash launched {build.counts()} times in the float evaluation")

    api_fk, api_fp, fparams = float_model(torch.bfloat16)
    lf_k, _ = _eval_losses(api_fk, fparams, batches)
    flash_launched()
    lf_p, _ = _eval_losses(api_fp, fparams, batches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(lf_k, lf_p))
    print(f"eval float weights, bf16: loss kernels {sum(lf_k) / 2:.6f} vs plain "
          f"{sum(lf_p) / 2:.6f}, max relative Δ {rel:.2e} (tol 1e-3)", flush=True)
    if rel > 1e-3:
        fail("without W4A4 the flash path's loss must agree with the plain path's to 1e-3")

    api_fk, api_fp, fparams = float_model(torch.float32)
    h_k = [forward_hidden(fparams, b["tokens"], cfg, api_fk.rt) for b in batches]
    flash_launched()
    for b, hk in zip(batches, h_k):
        hp = forward_hidden(fparams, b["tokens"], cfg, api_fp.rt)
        lk, lp = (lm_logits(fparams, h[:, ::64], api_fk.rt).float() for h in (hk, hp))
        for nm, a, r in (("hidden", hk, hp), ("logits", lk, lp)):
            d = float((a - r).abs().max() / r.abs().max())
            print(f"eval float weights, f32 {nm}: max|Δ|/max|plain| {d:.2e} (tol 1e-3)", flush=True)
            if not d <= 1e-3:
                fail(f"without W4A4 the flash path's {nm} must agree with the plain path's")

    idle = profile_forward(api_k, params, batches[0], ms_k[-1])
    return counts, err_in, {"loss": mean_k, "ppl": math.exp(mean_k), "ms": ms_k[-1],
                            "tokens_per_s": toks / ms_k[-1] * 1e3, "idle": idle}


NUDGES = 7  # nudged copies of the input embedding in the W4A4 loss gate


def nudged_params(params, r):
    """``params`` with each token's input-embedding row scaled by one bf16
    ulp, (1 + s·2^-7) with s = ±1 (in bf16 compute a 1-ulp f32 nudge
    vanishes in the cast): r = 1 every row up, r = 2 every row down, r ≥ 3
    seeded signs per row.  The tied output head keeps the original
    weights, so the nudge does not rescale every logit."""
    import torch

    emb = params["embed"]["kernel"]
    if r <= 2:
        s = 1.0 if r == 1 else -1.0
    else:
        g = torch.Generator().manual_seed(r)
        s = (torch.randint(0, 2, (emb.shape[0], 1), generator=g) * 2 - 1).to(emb)
    return dict(params, embed={"kernel": emb * (1 + s * 2**-7)}, lm_head={"kernel": emb.T})


def path_losses(api, params, batches, rs):
    """The mean held-out loss of ``api`` on each nudged copy r in ``rs``."""
    return [sum(ls) / len(ls) for ls in (_eval_losses(api, nudged_params(params, r), batches)[0]
                                         for r in rs)]


def w4a4_gate(api_k, api_p, params, batches, mean_k, mean_p):
    """The W4A4 evaluation loss gate.  W4A4 is chaotic at rounding level (a
    last-bit change of one linear's output moves the next encode), so one
    loss difference is one draw.  The gate pairs the two paths on the
    original weights and on NUDGES nudged copies: ``gap`` is |mean of the
    paired differences kernels − plain|, the kernel path's systematic
    offset; ``floor`` is the plain path's own noise, the mean |Δloss| of
    its nudged copies against the original.  It holds if gap ≤ 2 · floor."""
    rs = range(1, NUDGES + 1)
    lp = path_losses(api_p, params, batches, rs)
    lk = path_losses(api_k, params, batches, rs)
    paired = [mean_k - mean_p] + [k - p for k, p in zip(lk, lp)]
    floors = [abs(p - mean_p) for p in lp]
    out = {"gap": abs(sum(paired) / len(paired)), "floor": sum(floors) / len(floors),
           "paired": paired, "floors": floors}
    print(f"eval W4A4 gate: |mean paired Δloss| kernels − plain {out['gap']:.3e} "
          f"over {len(paired)} inputs (each {', '.join(f'{d:+.3e}' for d in paired)}); plain "
          f"noise floor {out['floor']:.3e} = mean |Δloss| under {NUDGES} 1-ulp embedding nudges "
          f"(each {', '.join(f'{f:.3e}' for f in floors)}); gate 2 × floor = "
          f"{2 * out['floor']:.3e}; one draw alone (original weights, first nudge): "
          f"{abs(paired[0]):.3e} vs 2 × {floors[0]:.3e}", flush=True)
    return out


def check_eval_launches(api, params, batch):
    """Hold every flash and fused-linear launch of one evaluation forward
    against its plain version on the very inputs the forward gave it (the
    launches of this check are not counted toward the main path's).
    Returns the worst max|err| per kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fused_linear_ref

    kernel_fa, plain_fa, kernel_lin = fa.flash_attention_kernel, fa.flash_attention_plain, ops.bcq_linear
    worst = {"flash_attention": [], "bcq_linear": []}

    def flash(q, k, v, causal=True):
        out = kernel_fa(q, k, v, causal)
        tol = FLASH_TOL[str(q.dtype).split(".")[1]]
        ok, err = held(out, plain_fa(q, k, v, causal), tol, tol)
        if not ok:
            fail(f"flash disagrees with its plain version on evaluation inputs {tuple(q.shape)} "
                 f"{q.dtype}: max|err| {err:.3e}")
        worst["flash_attention"].append(err)
        return out

    def linear(x, w_idx, w_sel, w_inv, cb, s_x, cfg):
        out = kernel_lin(x, w_idx, w_sel, w_inv, cb, s_x, cfg)
        ref = fused_linear_ref(x, w_idx, w_sel, w_inv, cb, cfg, s_x, valid_k=x.shape[1])
        ok, err = held(out, ref, LINEAR_TOL, LINEAR_TOL * float(ref.abs().max()))
        if not ok:
            fail(f"fused linear disagrees with its plain version on evaluation inputs "
                 f"M={x.shape[0]} K={x.shape[1]} N={w_idx.shape[0]}: max|err| {err:.3e}")
        worst["bcq_linear"].append(err)
        return out

    fa.flash_attention_kernel, ops.bcq_linear = flash, linear
    try:
        api.loss_fn(params, batch)
    finally:
        fa.flash_attention_kernel, ops.bcq_linear = kernel_fa, kernel_lin
    n = {name: len(v) for name, v in worst.items()}
    expect = {"flash_attention": api.cfg.n_layers, "bcq_linear": 6 * api.cfg.n_layers}
    if n != expect:
        fail(f"the evaluation forward made {n} launches, expected {expect}")
    out = {name: max(v) for name, v in worst.items()}
    print(f"every launch of one evaluation forward vs its plain version on its own inputs: "
          f"{n} ok, max|err| {out} (flash tol atol=rtol={FLASH_TOL['bfloat16']}, linear rtol="
          f"{LINEAR_TOL} atol={LINEAR_TOL}·max|plain|)", flush=True)
    return out


def profile_forward(api, params, batch, wall_ms):
    """Where one evaluation forward's time goes (torch.profiler)."""
    prof = _device_kernels(lambda: api.loss_fn(params, batch))
    if prof is None:
        print("eval forward profile: the profiler saw no device kernels (device time not "
              "measured)", flush=True)
        return None
    n_kern, busy, by_name, _ = prof
    idle = max(0.0, 1 - busy / wall_ms)
    print(f"eval forward profile: wall {wall_ms:.1f} ms unprofiled, {n_kern:.0f} CUDA kernels, "
          f"device busy {busy:.1f} ms (idle share {idle:.3f})", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} ms  {ms / busy:6.1%}  {name[:90]}", flush=True)
    return idle


# ------------------------------------------------------------------ phase 11
CORE_PREFIX, CORE_SUFFIX_SEED, CORE_REQUESTS = 320, 11, 12  # a 20-page shared system prefix
CORE_FORK, CORE_SAMPLED, CORE_HOT = 0, 5, 9  # the request kinds, by rid
CORE_PAGES = 98  # tight enough to preempt (three times: one request twice) and evict
CORE_SLAB = 4  # requests served again through slab admission
CORE_EOS_AT = 7  # eos_id = the token a greedy request emitted at this position
CORE_STATS = ("prefix_hits", "prefix_misses", "prefill_tokens_skipped", "forks",
              "shared_pages", "cow_copies", "preemptions", "prefix_evictions")


def core_requests(cfg):
    """The 12 requests of phase 11: each the shared 320-token prefix plus a
    suffix of 16–150 tokens; request 0 greedy with n_samples 2, request 5
    sampled with n_samples 3 (T 0.8, top-k 40, seed 1234), request 9
    sampled at T 1.0 over the whole vocabulary, the rest greedy."""
    from repro_torch.serving.generate import Request, SamplingParams

    rng = np.random.default_rng(CORE_SUFFIX_SEED)
    prefix = rng.integers(0, cfg.vocab, CORE_PREFIX)
    out = []
    for rid, n in enumerate(rng.integers(16, 151, CORE_REQUESTS)):
        suffix = np.random.default_rng(100 + rid).integers(0, cfg.vocab, int(n))
        n_samples, sp = 1, SamplingParams()
        if rid == CORE_FORK:
            n_samples = 2
        elif rid == CORE_SAMPLED:
            n_samples, sp = 3, SamplingParams(temperature=0.8, top_k=40, seed=1234)
        elif rid == CORE_HOT:
            sp = SamplingParams(temperature=1.0, seed=99)
        out.append(Request(rid=rid, prompt=np.concatenate([prefix, suffix]), max_new=GEN - 1,
                           n_samples=n_samples, sampling=sp))
    return out


def drive_core(api, params, reqs, chunked=True, eos_id=-1, n_pages=CORE_PAGES, setup=None,
               prof_steps=0, waves=(), allow_errors=False, **mode):
    """A fresh 8-slot engine (page 16, chunk 64, prefix caching on; eager
    at depth 1 unless ``mode`` — ``pipeline_depth``, ``cuda_graphs``,
    ``host_pages``, … — says otherwise; ``setup`` called on it first)
    serves ``reqs`` to completion, one ``step()`` at a time, then drains;
    then each of ``waves`` (lists of requests) the same way; a request
    finished with an error fails the run unless ``allow_errors``.  The host clock of
    every step that launched a decode tick and no prefill, with sampled
    rows, lands in ``eng.sampled_step_s``; the first ``prof_steps`` such
    steps after the first 4 run under torch.profiler instead
    (``eng.sampled_prof``: ``_tick_profile`` of each).  Returns (finished by
    (rid, sample_idx), engine, [(launches after the step, counters)] per
    step, launch counts of the run)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.serving.engine import PagedEngine

    mode = {"pipeline_depth": 1, "cuda_graphs": False, **mode}
    eng = PagedEngine(api, params, n_slots=8, max_len=512, page_size=16, n_pages=n_pages,
                      eos_id=eos_id, prefix_caching=True, chunked_prefill=chunked,
                      prefill_chunk=64, device="cuda", **mode)
    if setup is not None:
        setup(eng)
    trace, eng.sampled_step_s, eng.sampled_prof = [], [], []
    torch.cuda.synchronize()
    build.reset_counts()
    for wave in (reqs, *waves):
        for r in wave:
            eng.submit(r)
        while eng.queue or eng._active():
            launches, ticks = eng._launches, eng.stats["decode_ticks"]
            sampled = any(s.req is not None and s.mode == "decode" and not s.req.sampling.greedy
                          for s in eng.slots)
            n_seen = len(eng.sampled_step_s) + len(eng.sampled_prof)
            profiled = sampled and n_seen >= 4 and len(eng.sampled_prof) < prof_steps
            t0 = time.perf_counter()
            prof = _tick_profile(eng.step, 1) if profiled else eng.step()
            dt = time.perf_counter() - t0
            if eng._launches == launches or len(trace) > 2000:
                fail("phase 11: the engine stopped launching with requests left")
            if sampled and eng._launches == launches + 1 and eng.stats["decode_ticks"] == ticks + 1:
                if profiled:
                    eng.sampled_prof.append(prof)
                else:
                    eng.sampled_step_s.append(dt)
            trace.append((eng._launches, {k: eng.stats[k] for k in CORE_STATS}))
        eng.drain()
    torch.cuda.synchronize()
    counts = build.counts()
    eng.final_pool = {n: t.clone() for n, t in eng.pool.items()}
    if not allow_errors and any(r.error is not None for r in eng.finished):
        fail(f"phase 11: requests finished with errors: {[r.error for r in eng.finished]}")
    return {(r.rid, r.sample_idx): r for r in eng.finished}, eng, trace, counts


def core_clean(eng, what):
    """Page accounting after the drain: no reference held, every page free
    or parked, the parked pages exactly the registered ones."""
    free, parked = set(eng.pool_mgr.free), set(eng.prefix.reclaimable)
    if ((eng.pool_mgr.refcount != 0).any() or free & parked
            or free | parked != set(range(1, eng.pool_mgr.n_pages))
            or parked != set(eng.prefix.hash_of)):
        fail(f"phase 11: page accounting after the {what} run is not clean")
    return len(parked)


def core_counts(eng, counts, what):
    """Each kernel of the path launched layers × per-layer × passes times: a
    chunk prefill or decode pass runs all three, a slab prefill B1 only."""
    st, n_layers = eng.stats, eng.api.cfg.n_layers
    paged = st["decode_ticks"] + (st["prefill_launches"] if eng.chunked else 0)
    expect = {"bcq_linear": n_layers * 6 * (st["decode_ticks"] + st["prefill_launches"]),
              "page_gather": n_layers * paged, "bcq_page_write": n_layers * paged}
    for name, n in expect.items():
        if counts.get(name, 0) != n or n == 0:
            fail(f"phase 11: {name} launched {counts.get(name, 0)} times in the {what} run, "
                 f"expected {n}")
    return expect


def core_agreement(ref, got, tol, what):
    from repro_torch.serving.generate import greedy_agreement

    agree = greedy_agreement(ref, got, tol)
    print(f"phase 11 {what}: tokens kernels vs plain under the margin rule (logit tol "
          f"{tol:.3e}; a sampled token's margin is the logit change that could alter its "
          f"draw): {agree}", flush=True)
    if not agree["ok"]:
        fail(f"phase 11: {what} tokens of the kernel run and the plain run disagree beyond "
             f"the margin rule")
    return agree


def check_slab_linear(api, params, prompt):
    """Hold every fused-linear launch of one slab prefill (M = the prompt
    length) against its plain version on its own inputs; these launches
    are not counted toward the main path's."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fused_linear_ref

    kernel_lin, worst = ops.bcq_linear, []

    def linear(x, w_idx, w_sel, w_inv, cb, s_x, cfg):
        out = kernel_lin(x, w_idx, w_sel, w_inv, cb, s_x, cfg)
        ref = fused_linear_ref(x, w_idx, w_sel, w_inv, cb, cfg, s_x, valid_k=x.shape[1])
        ok, err = held(out, ref, LINEAR_TOL, LINEAR_TOL * float(ref.abs().max()))
        if not ok:
            fail(f"fused linear disagrees with its plain version on slab-prefill inputs "
                 f"M={x.shape[0]} K={x.shape[1]} N={w_idx.shape[0]}: max|err| {err:.3e}")
        worst.append(err)
        return out

    ops.bcq_linear = linear
    try:
        tokens = torch.tensor(prompt, dtype=torch.int32, device="cuda")[None]
        api.prefill_fn(params, {"tokens": tokens}, 512)
    finally:
        ops.bcq_linear = kernel_lin
    if len(worst) != 6 * api.cfg.n_layers:
        fail(f"a slab prefill made {len(worst)} fused-linear launches, expected "
             f"{6 * api.cfg.n_layers}")
    print(f"every fused-linear launch of one slab prefill (M={len(prompt)}) vs its plain "
          f"version on its own inputs: {len(worst)} ok, max|err| {max(worst):.3e}", flush=True)
    return max(worst)


def overlay_profile(eng):
    """Wrap the engine's sampler overlay so that its third call (a decode
    tick with sampled rows) runs under torch.profiler; the result lands in
    ``eng.overlay_prof``: (CUDA kernels, device ms) or None."""
    real, calls = eng._overlay_samples, []

    def overlay(*args):
        calls.append(1)
        if len(calls) != 3:
            return real(*args)
        out = []
        eng.overlay_prof = _device_kernels(lambda: out.append(real(*args)))
        eng.overlay_rows = len(args[3])
        return out[0]

    eng.overlay_prof = eng.overlay_rows = None
    eng._overlay_samples = overlay


def _choice(row, sp, sample_idx, pos):
    """(token, margin) the engine's sampler picks from one row of logits:
    the argmax and its top-2 gap for a greedy request, else the seeded
    draw keyed at ``pos`` (``generate.sample_token``)."""
    import torch

    from repro_torch.serving.generate import sample_token

    if not sp.greedy:
        return sample_token(row, sp, sample_idx, pos)
    top2 = torch.topk(row.float(), 2).values
    return int(row.float().argmax()), float(top2[0] - top2[1])


def shadow_setup(api_p, log):
    """A ``drive_core`` setup that runs every launch of the engine's kernel
    run through the plain paths too, on the same inputs and on a copy of
    the pool as the launch found it.  Per launch it appends to ``log``:
    (launch id, kind, max|Δ| of the rows' logits, [(key (rid,
    sample_idx), kernel choice, plain choice, features)] per token the
    launch books, COW copies so far).  A chunk or slab prefill books
    a token for each request it finishes (each sibling of a fork); a
    decode tick one for each decoding slot, keyed at ``pos + 1``.  With
    the decode step as a CUDA graph the decode launch is held at the
    engine's ``_run_decode`` instead (a capture must not see the plain
    path): the plain step gets the tokens the graph selects, on the row it
    was staged.  A decode launch's rows are read when the launch is made,
    so at depth 2 the record syncs on it (the booking stays one launch
    later)."""
    import dataclasses

    import torch

    def setup(eng):
        api_k = eng.api

        def record(kind, lk, lp, rows):
            """rows: (logit row, request, key position) per booked row."""
            toks, diff = [], 0.0
            for r, req, pos in rows:
                diff = max(diff, float((lk[r, -1].float() - lp[r, -1].float()).abs().max()))
                idx = range(req.n_samples) if req.n_samples > 1 else [req.sample_idx]
                feats = {f for f, on in (("sampled", not req.sampling.greedy),
                                         ("resumed", req._orig_plen is not None),
                                         ("fork", req.n_samples > 1)) if on}
                for k in idx:
                    toks.append(((req.rid, k), _choice(lk[r, -1], req.sampling, k, pos),
                                 _choice(lp[r, -1], req.sampling, k, pos), feats))
            log.append((eng._launches, kind, diff, toks, eng.stats["cow_copies"]))

        def decoding():
            return [(i, s.req, s.pos + 1) for i, s in enumerate(eng.slots)
                    if s.req is not None and s.mode == "decode"]

        def decode(params, pool, tokens, tables, lengths):
            lp, _ = api_p.paged_decode_fn(params, {n: t.clone() for n, t in pool.items()},
                                          tokens, tables, lengths)
            lk, pool = api_k.paged_decode_fn(params, pool, tokens, tables, lengths)
            record("decode", lk, lp, decoding())
            return lk, pool

        def run_decode(packed, real=eng._run_decode):
            tok = torch.where(packed[:, 1] == 1, packed[:, 0], eng._chain_tok)
            lp, _ = api_p.paged_decode_fn(eng.params, {n: t.clone() for n, t in eng.pool.items()},
                                          tok[:, None], packed[:, 3:], packed[:, 2])
            out = real(packed)
            record("decode", out[0], lp, decoding())
            return out

        def chunk(params, tokens, pool, tables, n_past, ids, chunk_len=None):
            lp, _ = api_p.prefill_from_pages_fn(
                params, tokens, {n: t.clone() for n, t in pool.items()}, tables, n_past, ids,
                chunk_len=chunk_len)
            lk, pool = api_k.prefill_from_pages_fn(params, tokens, pool, tables, n_past, ids,
                                                   chunk_len=chunk_len)
            batch = [s for s in eng.slots if s.req is not None and s.mode == "prefill"]
            record("chunk", lk, lp, [(r, s.req, len(s.pending)) for r, s in enumerate(batch)
                                     if len(s.pending) - s.pos <= eng.prefill_chunk])
            return lk, pool

        def slab(params, batch, max_len):
            lp, _ = api_p.prefill_fn(params, batch, max_len)
            lk, cache = api_k.prefill_fn(params, batch, max_len)
            req = eng.queue[0]  # admission pops it once the prefill is done
            record("slab", lk, lp, [(0, req, len(req.prompt))])
            return lk, cache

        if eng._graphs is None:
            eng.api = dataclasses.replace(api_k, paged_decode_fn=decode,
                                          prefill_from_pages_fn=chunk, prefill_fn=slab)
        else:
            eng.api = dataclasses.replace(api_k, prefill_from_pages_fn=chunk, prefill_fn=slab)
            eng._run_decode = run_decode

    return setup


def check_shadow(api_k, api_p, params, reqs, fin_ref, tol, what, need, **kw):
    """Every launch of a kernel run held to the plain paths on its own
    inputs (``shadow_setup``), so the comparison does not stop at the
    first launch where two runs' tokens part: max|Δ| of each launch's
    booked rows' logits at most 2 · ``tol`` (phase 4's yardstick, twice
    the noise floor); each booked token equal to the sampler on its own
    logits (the overlay, row by row) and, against the plain logits' pick,
    equal or a flip under the margin rule; the run's tokens equal
    ``fin_ref``'s bit for bit (the kernels are deterministic).  ``need``:
    the features whose tokens the run must have compared (``sampled``,
    ``resumed``, ``fork``, ``cow``).  Returns the per-launch log (see
    ``shadow_setup``)."""
    log = []
    fin, eng, _, _ = drive_core(api_k, params, reqs, setup=shadow_setup(api_p, log), **kw)
    if {k: (r.out, r.launch_ids) for k, r in fin.items()} != {
            k: (r.out, r.launch_ids) for k, r in fin_ref.items()}:
        fail(f"phase 11 {what}: the shadowed kernel run's tokens differ from the first kernel run's")
    if [e[0] for e in log] != list(range(eng._launches)):
        fail(f"phase 11 {what}: {len(log)} launches shadowed of {eng._launches}")
    got = {"sampled": 0, "resumed": 0, "fork": 0, "cow": 0}
    equal = flips = n_tok = 0
    worst, cow_before = 0.0, 0
    for launch, kind, diff, toks, cow in log:
        worst = max(worst, diff)
        if diff > 2 * tol:
            fail(f"phase 11 {what}: launch {launch} ({kind}) logits differ from the plain "
                 f"path's by {diff:.3e} > 2 · {tol:.3e}")
        cow_step = kind == "decode" and cow > cow_before
        for key, (tk, mk), (tp, mp), feats in toks:
            r = fin[key]
            at = [p for p, lid in enumerate(r.launch_ids) if lid == launch]
            if len(at) != 1:
                fail(f"phase 11 {what}: launch {launch} booked {len(at)} tokens for {key}")
            if r.out[at[0]] != tk or r.margins[at[0]] != mk:
                fail(f"phase 11 {what}: launch {launch} booked ({r.out[at[0]]}, "
                     f"{r.margins[at[0]]}) for {key}, its sampler on its logits gives ({tk}, {mk})")
            if tk == tp:
                equal += 1
            elif mk + mp <= 2 * tol:
                flips += 1
            else:
                fail(f"phase 11 {what}: launch {launch} ({kind}) {key}: kernel token {tk} "
                     f"(margin {mk:.3e}) vs plain {tp} (margin {mp:.3e}) beyond the margin rule")
            n_tok += 1
            for f in feats | ({"cow"} if cow_step else set()):
                got[f] += 1
        if kind == "decode":
            cow_before = cow
    if n_tok != sum(len(r.out) for r in fin.values()):
        fail(f"phase 11 {what}: {n_tok} tokens compared of {sum(len(r.out) for r in fin.values())}")
    missing = [f for f in need if not got[f]]
    if missing:
        fail(f"phase 11 {what}: the shadowed run compared no token of {missing}: {got}")
    print(f"phase 11 {what}, every launch held to the plain paths on its own inputs: "
          f"{len(log)} launches, {n_tok} tokens — {equal} equal, {flips} flips under the margin "
          f"rule; logits max|Δ| {worst:.3e} (≤ 2 · {tol:.3e}); tokens compared: {got['sampled']} "
          f"sampled, {got['resumed']} of resumed requests, {got['fork']} of forks at their "
          f"prefill, {got['cow']} in decode launches after a COW copy; booked tokens equal "
          f"their sampler on their own logits", flush=True)
    return log


def phase_core(eng4, tol):
    """Phase 11: the serving core (prefix caching, forking with
    copy-on-write, preemption, seeded sampling, EOS, slab admission) on
    full-width gpt3_126m through the kernels and through the plain paths.
    Returns the kernel run's launch counts and the slab prefill's worst
    fused-linear error."""
    import dataclasses

    from repro_torch.models import zoo

    cfg, params = eng4.api.cfg, eng4.params
    api_k = eng4.api
    api_p = zoo.build(cfg, dataclasses.replace(api_k.rt, paged_kernel=False, fused_linear=False),
                      device="cuda")
    fin_k, eng_k, trace_k, counts_k = drive_core(api_k, params, core_requests(cfg), prof_steps=3)
    fin_p, eng_p, trace_p, counts_p = drive_core(api_p, params, core_requests(cfg))
    for fin in (fin_k, fin_p):
        want = sorted([(r, 0) for r in range(CORE_REQUESTS)] + [(CORE_FORK, 1)]
                      + [(CORE_SAMPLED, 1), (CORE_SAMPLED, 2)])
        if sorted(fin) != want:
            fail(f"phase 11: finished {sorted(fin)}, expected {want}")
        for r in fin.values():
            if len(r.out) != GEN or not all(0 <= t < cfg.vocab_padded for t in r.out):
                fail(f"phase 11: request {r.rid}: {len(r.out)} tokens, expected {GEN} in [0, vocab)")
    st = eng_k.stats
    for name, st_ in (("kernels", st), ("plain  ", eng_p.stats)):
        print(f"phase 11 serving core [{name}]: decode "
              f"{1e3 * st_['t_decode_s'] / st_['decode_ticks']:.2f} ms/tick over "
              f"{st_['decode_ticks']} ticks, prefill "
              f"{st_['prefill_tokens'] / st_['t_prefill_s']:.0f} tok/s over "
              f"{st_['prefill_launches']} launches ({st_['prefill_tokens']} tokens run); "
              f"prefill tokens skipped by prefix hits {st_['prefill_tokens_skipped']}; "
              f"hits {st_['prefix_hits']} misses {st_['prefix_misses']}, preemptions "
              f"{st_['preemptions']}, evictions {st_['prefix_evictions']}, forks "
              f"{st_['forks']} (shared pages {st_['shared_pages']}), COW copies "
              f"{st_['cow_copies']}", flush=True)
    if st["preemptions"] < 1 or st["cow_copies"] < 1 or st["prefill_tokens_skipped"] <= 0:
        fail(f"phase 11 must preempt, copy on write and skip prefix-hit tokens: {st}")
    # 1. kernel run against plain run, and their counters up to the first
    # launch with a differing token
    agree = core_agreement(fin_p, fin_k, tol, "chunked")
    first = agree["first_diff_launch"]
    n_cmp = 0
    for (la, sk), (lb, sp) in zip(trace_k, trace_p):
        if first is not None and max(la, lb) > first:
            break
        if la != lb or sk != sp:
            fail(f"phase 11: counters differ before the first differing token: {sk} vs {sp}")
        n_cmp += 1
    if first is None and len(trace_k) != len(trace_p):
        fail("phase 11: the runs agree token for token but not in their steps")
    print(f"phase 11: counters equal over the first {n_cmp} steps (every step before the first "
          f"differing token, launch {first})", flush=True)
    check_shadow(api_k, api_p, params, core_requests(cfg), fin_k, tol, "chunked",
                 ("sampled", "resumed", "fork", "cow"))
    # 2. launch counts
    expect = core_counts(eng_k, counts_k, "kernel")
    if any(counts_p.get(n, 0) for n in expect):
        fail(f"phase 11: kernels launched in the plain run: {counts_p}")
    print(f"phase 11 launch counts match layers × per-layer × passes: {expect}", flush=True)
    # 3. page accounting
    parked = [core_clean(e, w) for e, w in ((eng_k, "kernel"), (eng_p, "plain"))]
    print(f"phase 11 page accounting after the drain: refcounts 0, every page free or parked, "
          f"parked == registered ({parked} parked)", flush=True)
    # 4. the greedy fork
    if fin_k[(CORE_FORK, 0)].out != fin_k[(CORE_FORK, 1)].out:
        fail("phase 11: the greedy fork's siblings differ")
    print(f"phase 11 greedy fork: both siblings {fin_k[(CORE_FORK, 0)].out[:8]}... equal",
          flush=True)
    # 5. EOS: the token a greedy request emitted at position CORE_EOS_AT,
    # where that is the first time any request decoded it
    def first_eos(tok):
        return min(((r.launch_ids[p], key, p) for key, r in fin_k.items()
                    for p in range(1, len(r.out)) if r.out[p] == tok), default=None)

    pick = next((first_eos(r.out[CORE_EOS_AT]) for key, r in sorted(fin_k.items())
                 if r.sampling.greedy and key[0] != CORE_FORK
                 and first_eos(r.out[CORE_EOS_AT])[1:] == (key, CORE_EOS_AT)), None)
    if pick is None:
        fail("phase 11: no greedy request's token at position 7 is a first occurrence")
    stop_launch, key, stop = pick
    eos = fin_k[key].out[stop]
    fin_e, eng_e, _, _ = drive_core(api_k, params, core_requests(cfg), eos_id=int(eos),
                                    setup=overlay_profile)
    if fin_e[key].out != fin_k[key].out[: stop + 1]:
        fail(f"phase 11: with eos_id {eos} request {key} gave {fin_e[key].out}, expected "
             f"{fin_k[key].out[: stop + 1]}")
    for k, r in fin_e.items():
        if eos in r.out[1:-1]:
            fail(f"phase 11: request {k} ran past eos_id {eos}")
        before = [t for t, lid in zip(fin_k[k].out, fin_k[k].launch_ids) if lid <= stop_launch]
        if [t for t, lid in zip(r.out, r.launch_ids) if lid <= stop_launch] != before:
            fail(f"phase 11: with eos_id set, request {k} differs before the stop")
    core_clean(eng_e, "EOS")
    prof = eng_e.overlay_prof
    prof_txt = ("the profiler saw no device kernels (not measured)" if prof is None else
                f"{prof[0]:.0f} CUDA kernels, device {prof[1]:.4f} ms")
    print(f"phase 11 EOS: eos_id {eos} (request {key}'s token {stop}) stops it there, launch "
          f"{stop_launch}; every token of every request up to that launch equals the first "
          f"kernel run's; sampler overlay of one decode tick ({eng_e.overlay_rows} sampled "
          f"rows): {prof_txt}", flush=True)
    # 6. slab admission
    slab = core_requests(cfg)[:CORE_SLAB]
    err = check_slab_linear(api_k, params, slab[1].prompt)
    fin_sk, eng_sk, _, counts_sk = drive_core(api_k, params, slab, chunked=False, n_pages=None)
    fin_sp, eng_sp, _, counts_sp = drive_core(api_p, params, core_requests(cfg)[:CORE_SLAB],
                                              chunked=False, n_pages=None)
    core_agreement(fin_sp, fin_sk, tol, "slab")
    check_shadow(api_k, api_p, params, core_requests(cfg)[:CORE_SLAB], fin_sk, tol, "slab",
                 ("fork", "cow"), chunked=False, n_pages=None)
    expect_s = core_counts(eng_sk, counts_sk, "slab kernel")
    if any(counts_sp.get(n, 0) for n in expect_s):
        fail(f"phase 11: kernels launched in the plain slab run: {counts_sp}")
    for e, w in ((eng_sk, "slab kernel"), (eng_sp, "slab plain")):
        core_clean(e, w)
    ss = eng_sk.stats
    print(f"phase 11 slab admission ({CORE_SLAB} requests, one prefill each over a 512 slab): "
          f"launches {expect_s}, prefill {ss['prefill_tokens'] / ss['t_prefill_s']:.0f} tok/s, "
          f"hits {ss['prefix_hits']} misses {ss['prefix_misses']}", flush=True)
    core_plain_work(eng_k, api_k, params, slab[1].prompt, eng_e.overlay_prof)
    return ({n: counts_k[n] + counts_sk.get(n, 0) for n in expect}, err,
            (api_p, fin_k, eng_k, trace_k, counts_k))


def core_plain_work(eng, api, params, prompt, overlay):
    """The serving core's device work that the reference does in jnp and no
    Pallas kernel, timed on the card: the copy-on-write page copy, the slab
    prefill's scatter into the pool, the whole slab prefill (its linears
    through B1, its cache write and read plain), and the sampler overlay
    (profiled in the EOS run).  Runs after the counted runs."""
    import torch

    from repro_torch.serving import pages

    ms_copy = cuda_ms(lambda: pages.copy_page(eng.pool, 1, 2))
    tokens = torch.tensor(prompt, dtype=torch.int32, device="cuda")[None]
    _, cache1 = api.prefill_fn(params, {"tokens": tokens}, 512)
    ids = torch.zeros(32, dtype=torch.int32, device="cuda")
    n = -(-len(prompt) // 16)
    ids[:n] = torch.arange(3, 3 + n, dtype=torch.int32, device="cuda")
    ms_scatter = cuda_ms(lambda: pages.scatter_prefill_pages(eng.pool, cache1, ids))
    ms_prefill = cuda_ms(lambda: api.prefill_fn(params, {"tokens": tokens}, 512), iters=5,
                         warmup=1)
    n_layers = eng.api.cfg.n_layers
    page_bytes = sum(t[0, 0].numel() * t.element_size() for t in eng.pool.values()
                     if t.ndim >= 3) * n_layers
    ov = "not measured" if overlay is None else f"{overlay[1]:.4f} ms device ({overlay[0]:.0f} CUDA kernels)"
    print(f"phase 11 plain device work (jnp in the reference, plain torch here): copy_page "
          f"{ms_copy:.4f} ms ({page_bytes} B a page over {n_layers} layers), scatter_prefill_pages of a "
          f"{len(prompt)}-token slab {ms_scatter:.4f} ms, one slab prefill at M={len(prompt)} "
          f"{ms_prefill:.2f} ms, sampler overlay of one decode tick {ov}", flush=True)


# ------------------------------------------------------------------ phase 12
HOST_KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                        "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
COUNTED = ("bcq_linear", "page_gather", "bcq_page_write")


def _tick_profile(fn, n):
    """``fn`` called ``n`` times under torch.profiler: (CUDA kernels, device
    busy ms, host kernel launches, host ``cudaGraphLaunch`` calls) per call,
    or None where the profiler saw no device kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    host = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    return (len(kern) / n, sum(e.time_range.elapsed_us() for e in kern) / n / 1e3,
            sum(h in HOST_KERNEL_LAUNCHES for h in host) / n, host.count("cudaGraphLaunch") / n)


def _steady_profile(eng, label, rows, n=3, tries=3):
    """``_tick_profile`` of ``n`` steady ticks of ``eng`` (``rows`` rows
    decoding).  The ticks of a window are alike, so a window with no
    device kernel, or with a host launch count that is not a whole number
    a tick, is one where the profiler dropped events: it is profiled
    again, up to ``tries`` windows, and the last one stands (the caller's
    checks then judge it)."""
    for _ in range(tries):
        if sum(s.req is not None for s in eng.slots) != rows:
            fail(f"{label}: the steady window lost a decoding row")
        prof = _tick_profile(eng.step, n)
        if prof is not None and all(abs(prof[i] * n - round(prof[i] * n)) < 1e-6
                                    for i in (2, 3)):
            return prof
        print(f"  ({label}: torch.profiler dropped events of a steady window of {n} ticks "
              f"{prof}; profiled again)", flush=True)
    return prof


def _outcome(eng, fin=None):
    """What two ways of one workload must give bit for bit: each request's
    tokens, margins and launch indices, every engine counter but the
    clocks."""
    from repro_torch.serving.engine import ENGINE_STAT_KEYS

    fin = {(r.rid, r.sample_idx): r for r in eng.finished} if fin is None else fin
    return ({k: (list(r.out), list(r.margins), list(r.launch_ids)) for k, r in fin.items()},
            {k: eng.stats[k] for k in ENGINE_STAT_KEYS if not k.startswith("t_")})


def _same_pool(a: dict, b: dict) -> bool:
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


def _way_name(graphs, depth):
    return f"{'graph' if graphs else 'eager'} depth {depth}"


def _profile_txt(prof, wall):
    if prof is None:
        return "the profiler saw no device kernels (device busy not measured)"
    kern, busy, launches, graphs = prof
    return (f"device busy {busy:.3f} ms/tick, idle share {max(0.0, 1 - busy / wall):.3f}, "
            f"{kern:.0f} CUDA kernels/tick, host launches/tick: {launches:.0f} kernel "
            f"launches + {graphs:.0f} cudaGraphLaunch")


def production_way(eng4, prompts, graphs, depth, n_time, label="phase 12", api=None, **extra):
    """Phase 4's workload on a fresh engine in one way (``graphs``,
    ``depth``; ``extra`` engine arguments; ``api`` instead of phase 4's, on
    its weights): served to completion (what it gives, its pool, launch
    counts and captures), then served again by the warmed engine, which
    must capture nothing new, with ``n_time`` steady ticks (8 rows
    decoding) timed on the host clock and 3 more profiled."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.generate import Request

    eng = PagedEngine(api or eng4.api, eng4.params, n_slots=len(prompts), max_len=eng4.max_len,
                      page_size=16, prefill_chunk=64, chunked_prefill=True,
                      prefix_caching=False, device="cuda", pipeline_depth=depth,
                      cuda_graphs=graphs, **extra)

    def submit():
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=GEN - 1))

    submit()
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = build.counts()
    out = _outcome(eng)
    pool = {n: t.clone() for n, t in eng.pool.items()}
    captures = eng.trace_counts()["decode"]
    buckets = len(eng._graphs.buckets) if graphs else 0
    if captures != buckets or (graphs and not captures):
        fail(f"{label} [{_way_name(graphs, depth)}]: {captures} decode captures on a fresh "
             f"engine over {buckets} block-table widths")
    submit()
    while eng.queue or any(s.mode == "prefill" for s in eng.slots if s.req is not None):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_time):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_time * 1e3
    prof = _steady_profile(eng, label, len(prompts))
    eng.run_to_completion()
    torch.cuda.synchronize()
    again = eng.trace_counts()["decode"] - captures
    if again:
        fail(f"{label} [{_way_name(graphs, depth)}]: the warmed engine captured {again} more")
    print(f"{label} [{_way_name(graphs, depth)}] phase 4's workload: run {run_s:.2f} s "
          f"({out[1]['decode_ticks']} decode ticks, {out[1]['prefill_launches']} prefill "
          f"launches), captures {captures} fresh / {again} warmed; steady tick (8 rows, "
          f"{n_time} ticks): wall {wall:.2f} ms/tick, {_profile_txt(prof, wall)}", flush=True)
    nodes = {w: eng._graphs.node_count(w) for w in eng._graphs.buckets} if graphs else {}
    return {"out": out, "pool": pool, "counts": counts, "wall": wall, "prof": prof,
            "captures": captures, "nodes": nodes, "engine": eng}


def _hold_ways(ways, what, label="phase 12"):
    """Every way of one workload equal to the first, bit for bit (and in
    the parts ``out`` holds beyond tokens and counters)."""
    (name0, ref), rest = ways[0], ways[1:]
    for name, w in rest:
        for part, a, b in (("tokens, margins and launch indices", w["out"][0], ref["out"][0]),
                           ("engine counters", w["out"][1], ref["out"][1]),
                           ("error kinds and health counters", w["out"][2:], ref["out"][2:]),
                           ("kernel launch counts", w["counts"], ref["counts"])):
            if a != b:
                fail(f"{label} {what}: {name} and {name0} differ in their {part}")
        if not _same_pool(w["pool"], ref["pool"]):
            fail(f"{label} {what}: {name} and {name0} leave different pool bytes")


def _sampled_txt(eng):
    walls = eng.sampled_step_s
    if not walls:
        fail("phase 12: no decode-only step with sampled rows was timed")
    wall = 1e3 * float(np.mean(walls))
    profs = [p for p in eng.sampled_prof if p is not None]
    prof = tuple(float(np.mean([p[i] for p in profs])) for i in range(4)) if profs else None
    return wall, (f"wall {wall:.2f} ms/step over {len(walls)} decode-only steps with sampled "
                  f"rows; over {len(profs)} profiled such steps {_profile_txt(prof, wall)}")


def phase_production(eng4, tol, core):
    """Phase 12: the production tick — the decode step as one CUDA graph
    per block-table width, at pipeline depth 2 — against the eager step.
    Phase 4's workload three ways (eager depth 1, graph depth 1, graph
    depth 2) and phase 11's two (eager depth 1: phase 11's kernel run;
    graph depth 2) must give the same tokens, margins, launch indices,
    counters, pool bytes and kernel launch counts; phase 11's graph depth
    2 run is held launch by launch to the plain paths (``check_shadow``).
    Returns the graph depth 2 runs' launch counts."""
    from repro_torch.configs.base import get_arch

    cfg = get_arch("gpt3_126m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    ways = [(_way_name(g, d), production_way(eng4, prompts, g, d, n))
            for g, d, n in ((False, 1, 3), (True, 1, 10), (True, 2, 10))]
    _hold_ways(ways, "phase 4's workload")
    for name, w in ways[1:]:
        if w["prof"] is not None and (w["prof"][3] != 1 or w["prof"][2] != 0):
            fail(f"phase 12 [{name}]: a steady greedy tick made {w['prof'][3]} cudaGraphLaunch "
                 f"and {w['prof'][2]} kernel launches from the host")
    eager = ways[0][1]
    print(f"phase 12 phase 4's workload: eager depth 1, graph depth 1 and graph depth 2 equal bit "
          f"for bit (tokens, margins, launch indices, counters, pool bytes, launch counts "
          f"{eager['counts']}); steady tick wall "
          + ", ".join(f"{n} {w['wall']:.2f}" for n, w in ways) + " ms", flush=True)

    api_p, fin_k, eng_k, trace_k, counts_k = core
    api_k, params = eng4.api, eng4.params
    fin_g, eng_g, trace_g, counts_g = drive_core(api_k, params, core_requests(cfg), prof_steps=3,
                                                 cuda_graphs=True, pipeline_depth=2)
    core_ways = [("eager depth 1", {"out": _outcome(eng_k, fin_k), "counts": counts_k,
                                    "pool": eng_k.final_pool}),
                 ("graph depth 2", {"out": _outcome(eng_g, fin_g), "counts": counts_g,
                                    "pool": eng_g.final_pool})]
    _hold_ways(core_ways, "phase 11's workload")
    if trace_g != trace_k:
        fail("phase 12 phase 11's workload: the graph depth 2 run's steps differ from eager's")
    caps = eng_g.trace_counts()["decode"]
    if caps != len(eng_g._graphs.buckets) or not caps:
        fail(f"phase 12: {caps} captures over {len(eng_g._graphs.buckets)} widths")
    core_clean(eng_g, "graph depth 2")
    wall_k, txt_k = _sampled_txt(eng_k)
    wall_g, txt_g = _sampled_txt(eng_g)
    print(f"phase 12 phase 11's workload: eager depth 1 and graph depth 2 equal bit for bit "
          f"({len(trace_g)} steps, {eng_g.stats['decode_ticks']} decode ticks, {caps} capture); "
          f"sampled decode steps — eager depth 1: {txt_k}; graph depth 2: {txt_g}; graph "
          f"depth 2 takes {wall_g / wall_k:.3f} of eager's wall", flush=True)
    check_shadow(api_k, api_p, params, core_requests(cfg), fin_k, tol, "chunked, graph depth 2",
                 ("sampled", "resumed", "fork", "cow"), cuda_graphs=True, pipeline_depth=2)
    g2 = ways[2][1]["counts"]
    return ({n: g2.get(n, 0) + counts_g.get(n, 0) for n in COUNTED}, ways[2][1],
            (core_ways[1][1], eng_g))


# ------------------------------------------------------------------ phase 13
# The pinned fault schedule of phase 13, chosen from a CPU rehearsal of its
# schedule (which does not depend on the tokens): the decode launch of tick
# 10 delayed; the sampler raising for slot 6 at tick 12 (a sibling of the
# sampled fork, request 5); the logits of slot 2 at tick 15 read non-finite
# (request 1, decoding); request 8's planned prefix hits dropped at tick 21
# (its whole prompt recomputes); the 165th allocator query, the first of
# tick 23, dry (request 8's chunk pages: a preemption).
CONTAIN_SCHEDULE = [(10, "launch", 1), (12, "sampler", 6), (15, "logits", 2),
                    (21, "prefix_claim"), (23, "alloc", 165)]
CONTAIN_CANCEL = (4, 20)  # request 4 cancelled after tick 20, mid-decode
# request 3 is preempted while it prefills and waits in the queue: no token
# for more than 7 ticks (without the preemption its first token comes at 6)
CONTAIN_STALL = (3, 7)
CONTAIN_DEADLINE = (12, 13)  # two more requests, deadline_s 0.0: expired in the queue
CONTAIN_AUDIT_EVERY = 4
# what the schedule must do, by (rid, sample_idx); every other request clean
CONTAIN_KINDS = {(1, 0): "quarantined", (3, 0): "expired", (4, 0): "cancelled",
                 (5, 1): "quarantined", (12, 0): "expired", (13, 0): "expired"}
CONTAIN_SITES = {"alloc", "prefix_claim", "launch", "logits", "sampler"}
# a steady greedy graph depth 2 tick of phase 4's workload in an earlier run of
# this script, before the engine had containment (PERF.md §5; NVIDIA H100
# 80GB HBM3 at 700 W): CUDA kernels a tick (torch.profiler), wall ms
EARLIER_TICK = (1492, 3.52)


def contain_requests(cfg):
    """Phase 11's 12 requests, request 3 with ``max_output_stall_ticks``, and
    two more on the shared prefix with ``deadline_s`` 0.0."""
    from repro_torch.serving.generate import Request

    reqs = core_requests(cfg)
    reqs[CONTAIN_STALL[0]].max_output_stall_ticks = CONTAIN_STALL[1]
    rng = np.random.default_rng(5)
    for rid in CONTAIN_DEADLINE:
        reqs.append(Request(rid=rid, max_new=GEN - 1, deadline_s=0.0, prompt=np.concatenate(
            [reqs[0].prompt[:CORE_PREFIX], rng.integers(0, cfg.vocab, 20)])))
    return reqs


def drive_contained(api, params, what, **mode):
    """A fresh phase 11 engine (eager at depth 1 unless ``mode`` says
    otherwise) with the pinned fault schedule, an audit every 4 ticks, and
    phase 13's requests; request 4 cancelled between two steps.  Every
    check of what it leaves: no exception escaped, every request finished
    clean or with the expected typed error, every fault site fired, page
    accounting and the final audit clean.  Returns (finished by (rid,
    sample_idx), engine, the way's record for ``_hold_ways``)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.serving.audit import audit_engine
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.faults import FaultInjector

    mode = {"pipeline_depth": 1, "cuda_graphs": False, **mode}
    faults = FaultInjector(seed=0, schedule=CONTAIN_SCHEDULE)
    eng = PagedEngine(api, params, n_slots=8, max_len=512, page_size=16, n_pages=CORE_PAGES,
                      prefix_caching=True, chunked_prefill=True, prefill_chunk=64,
                      device="cuda", fault_injector=faults, audit_every=CONTAIN_AUDIT_EVERY,
                      **mode)
    reqs = contain_requests(api.cfg)
    torch.cuda.synchronize()
    build.reset_counts()
    try:
        for r in reqs:
            eng.submit(r)
        while eng.queue or eng._active():
            eng.step()
            if eng._tick == CONTAIN_CANCEL[1]:
                next(r for r in reqs if r.rid == CONTAIN_CANCEL[0]).cancel()
            if eng._tick > 1000:
                fail(f"phase 13 [{what}]: the engine did not drain in 1000 ticks")
        eng.drain()
    except Exception as exc:  # what containment must never let through
        fail(f"phase 13 [{what}]: an exception escaped the engine: {type(exc).__name__}: {exc}")
    torch.cuda.synchronize()
    counts = build.counts()
    fin = {(r.rid, r.sample_idx): r for r in eng.finished}
    kinds = {k: r.error.kind for k, r in fin.items() if r.error is not None}
    want = sorted([(r, 0) for r in range(CORE_REQUESTS)] + [(CORE_FORK, 1), (CORE_SAMPLED, 1),
                  (CORE_SAMPLED, 2)] + [(r, 0) for r in CONTAIN_DEADLINE])
    if sorted(fin) != want or kinds != CONTAIN_KINDS:
        fail(f"phase 13 [{what}]: finished {sorted(fin)} with errors {kinds}, expected {want} "
             f"with {CONTAIN_KINDS}")
    for k, r in fin.items():
        if r.error is None and (len(r.out) != GEN or not all(0 <= t < api.cfg.vocab_padded
                                                             for t in r.out)):
            fail(f"phase 13 [{what}]: clean request {k}: {len(r.out)} tokens, expected {GEN}")
    fired = {e.site for e in faults.log}
    health = eng.health()
    audit = audit_engine(eng)
    if fired != CONTAIN_SITES or not audit.ok or health["counters"]["audit_failures"] \
            or eng._last_audit is None or not eng._last_audit.ok:
        fail(f"phase 13 [{what}]: faults fired at {fired} (expected {CONTAIN_SITES}), final "
             f"audit {audit.violations}, health {health}")
    core_clean(eng, f"phase 13 {what}")
    pool = {n: t.clone() for n, t in eng.pool.items()}
    out = (*_outcome(eng, fin), kinds, health["counters"])
    return fin, eng, {"out": out, "counts": counts, "pool": pool}


def _chaos_runs(api, params, cfg):
    """The serving CLI's chaos smoke (``launch.serve.run_chaos``, the CLI's
    defaults: 4 prompts of 32 tokens, 16 tokens each, rate 0.05, seed 0)
    at graph depth 2, its report checked by ``tools/check_chaos.py``, and
    again eagerly at depth 1: the two outcomes equal.  Returns the graph
    depth 2 run's launch counts."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import serve

    prompts = list(np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)))
    path = os.path.join(ROOT, "build", "chaos_report.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    build.reset_counts()
    rep = serve.run_chaos(api, params, prompts, 16, report_path=path)
    torch.cuda.synchronize()
    counts = build.counts()
    check = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "check_chaos.py"), path],
                           capture_output=True, text=True, timeout=120)
    print(f"phase 13 tools/check_chaos.py (exit {check.returncode}): "
          f"{(check.stdout + check.stderr).strip()}", flush=True)
    if check.returncode != 0 or rep["faults"]["total"] == 0:
        fail("phase 13: the chaos report fails tools/check_chaos.py (or no fault fired)")
    rep1 = serve.run_chaos(api, params, prompts, 16, pipeline_depth=1, cuda_graphs=False)
    key = lambda r: (sorted((o["rid"], o["sample_idx"], o["error_kind"], o["n_out"])  # noqa: E731
                            for o in r["requests"]), r["faults"]["by_site"], r["ticks"],
                     r["health"]["counters"])
    if key(rep) != key(rep1):
        fail(f"phase 13: the chaos run at graph depth 2 and eagerly at depth 1 differ: "
             f"{key(rep)} vs {key(rep1)}")
    print(f"phase 13 chaos run (rate 0.05, seed 0): graph depth 2 and eager depth 1 equal in "
          f"outcomes, faults {rep['faults']['by_site']} and counters "
          f"{rep['health']['counters']}", flush=True)
    return counts


def phase_containment(eng4, tol, core, g2, smi):
    """Phase 13: containment on the card.  Phase 13's requests under the
    pinned fault schedule through the kernels at graph depth 2 and eagerly
    at depth 1, and through the plain paths eagerly at depth 1: the two
    kernel ways bit-equal (tokens, margins, launch indices, error kinds,
    engine and health counters, pool bytes, launch counts), the kernel and
    plain runs equal in error kinds and under the margin rule in tokens,
    the kernels launched layers × per-layer × passes times; the CLI's
    chaos run and its report; the default engine with an audit every 8
    ticks on phase 12's steady greedy graph tick.  Returns the kernel
    runs' launch counts."""
    from repro_torch.configs.base import get_arch

    cfg = get_arch("gpt3_126m")
    api_p = core[0]
    api_k, params = eng4.api, eng4.params
    runs = {}
    for name, api, mode in (("graph depth 2", api_k, {"cuda_graphs": True, "pipeline_depth": 2}),
                            ("eager depth 1", api_k, {}), ("plain eager depth 1", api_p, {})):
        t0 = time.perf_counter()
        runs[name] = drive_contained(api, params, name, **mode)
        print(f"phase 13 [{name}]: {time.perf_counter() - t0:.2f} s, "
              f"{runs[name][1].stats['decode_ticks']} decode ticks, "
              f"{runs[name][1].stats['prefill_launches']} prefill launches, "
              f"{runs[name][1]._tick} ticks; errors {CONTAIN_KINDS}; health counters "
              f"{runs[name][2]['out'][3]}", flush=True)
    _hold_ways([(n, runs[n][2]) for n in ("eager depth 1", "graph depth 2")],
               "pinned schedule", "phase 13")
    fin_k, eng_k, way_k = runs["eager depth 1"]
    fin_p, eng_p, way_p = runs["plain eager depth 1"]
    if way_p["out"][2:] != way_k["out"][2:]:
        fail("phase 13: the kernel and plain runs differ in error kinds or health counters")
    core_agreement(fin_p, fin_k, tol, "containment")
    for name in ("graph depth 2", "eager depth 1"):
        core_counts(runs[name][1], runs[name][2]["counts"], f"phase 13 {name}")
    if any(way_p["counts"].get(n, 0) for n in COUNTED):
        fail(f"phase 13: kernels launched in the plain run: {way_p['counts']}")
    print("phase 13 pinned schedule: graph depth 2 ≡ eager depth 1 bit for bit (tokens, margins, "
          "launch indices, error kinds, counters, pool bytes, launch counts "
          f"{runs['graph depth 2'][2]['counts']}); plain ≡ kernels in error kinds; 0 leaked "
          "pages, final audit clean", flush=True)
    counts_chaos = _chaos_runs(api_k, params, cfg)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    w = production_way(eng4, prompts, True, 2, 10, label="phase 13", audit_every=8)
    _hold_ways([("phase 12 graph depth 2", g2), ("audit every 8", w)], "phase 4's workload",
               "phase 13")
    # the graph's node count is exact; the profiler's kernels a tick may
    # lose or gain a few events in a window
    prof = w["prof"]
    if w["nodes"] != g2["nodes"] or not w["nodes"] or prof is None or prof[2] != 0 \
            or prof[3] != 1:
        fail(f"phase 13: the default engine's steady greedy graph tick with audit_every=8 "
             f"(graph nodes {w['nodes']}; kernels, busy, host kernel launches, cudaGraphLaunch "
             f"a tick {prof}) is not phase 12's (graph nodes {g2['nodes']}; {g2['prof']})")
    eng_a = w["engine"]
    t0 = time.perf_counter()
    for _ in range(20):
        eng_a.audit()
    audit_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"phase 13 default engine, audit every 8 ticks: steady greedy graph depth 2 tick wall "
          f"{w['wall']:.2f} ms (phase 12's default engine in this run {g2['wall']:.2f} ms; an "
          f"earlier run without containment {EARLIER_TICK[1]} ms); one audit of its "
          f"{eng_a.pool_mgr.n_pages}-page pool and {eng_a.n_slots} slots takes {audit_ms:.3f} ms "
          f"of host time (host clock, 20 calls); decode graph nodes {w['nodes']} (phase 12's "
          f"{g2['nodes']}); torch.profiler: {prof[0]:.2f} CUDA kernels/tick (phase 12's "
          f"{g2['prof'][0]:.2f}; the earlier run {EARLIER_TICK[0]}), {prof[3]:.0f} cudaGraphLaunch "
          f"and {prof[2]:.0f} host kernel launches a tick; card {smi}", flush=True)
    total = {}
    for c in (runs["graph depth 2"][2]["counts"], way_k["counts"], counts_chaos, w["counts"]):
        for n in COUNTED:
            total[n] = total.get(n, 0) + c.get(n, 0)
    return total


# ------------------------------------------------------------------ phase 14
PROBE_SITES = ("attn_qkv", "attn_out", "mlp_in", "mlp_out")  # B3 launches a layer and pass
PROBE_NMSE_RTOL = 1e-6  # probe NMSE, kernel encode vs plain encode of one x (f32 sums)
TIE_RTOL = 2e-6  # a block's two codebook errors this close are a tie (f32 sum of 8 squares)
# phase 12's default decode graph in an earlier run of this script (PERF.md
# §5; NVIDIA H100 80GB HBM3 at 700 W): graph nodes, wall ms of a
# steady greedy graph depth 2 tick
EARLIER_DEFAULT_TICK = (1490, 3.50)


def probe_model(api):
    """``api``'s model with a quant-error probe (the weights stay the
    caller's): (api, recorder)."""
    import dataclasses

    from repro_torch.models import zoo
    from repro_torch.serving.telemetry import QuantProbeRecorder

    rec = QuantProbeRecorder(None)
    return zoo.build(api.cfg, dataclasses.replace(api.rt, quant_probe=rec), device=api.device), rec


def attach_sink(rec, cfg):
    """A fresh ``QuantProbeSink`` behind ``rec``, as ``--quant-probes`` makes
    it, and the log of every emission it gets: (sink, log)."""
    from repro_torch.serving.telemetry import QuantProbeSink

    sink, log = QuantProbeSink(n_layers=cfg.n_layers), []

    def feed(site, nmse, occ):
        log.append((site, nmse, occ.tolist()))
        sink(site, nmse, occ)

    rec.sink = feed
    return sink, log


def probe_ties(x, cb, cfg):
    """The blocks of x where the quantize kernel and ``bcq.encode`` select
    other codebooks, each checked to be a tie (its two block errors, in
    f64 from the normalized values, within TIE_RTOL).  Returns their
    number."""
    from repro_torch.core import bcq
    from repro_torch.kernels.bcq_quantize import bcq_quantize

    x2 = x.reshape(-1, x.shape[-1]).float()
    s_x = bcq.tensor_scale(x2, cfg)
    xp, _ = bcq.pad_to_multiple(x2, cfg.array_len)
    ksel = bcq.unpack_nibbles(bcq_quantize(xp.contiguous(), cb, s_x, cfg)[1])
    psel = bcq.unpack_nibbles(bcq.encode(x2, cb, cfg, s_x).packed_sel)
    arrays = xp.reshape(xp.shape[0], -1, cfg.array_len)
    _, scale = bcq._array_scales(arrays, cfg, s_x)
    y = (arrays * scale[..., None]).reshape(xp.shape[0], -1, cfg.block_len)
    diff = (ksel[:, : y.shape[1]] != psel[:, : y.shape[1]]).nonzero().tolist()
    for r, b in diff:
        errs = []
        for c in (int(ksel[r, b]), int(psel[r, b])):
            q = cb[c][bcq.nearest_level_idx(y[r, b].contiguous(), cb[c].contiguous())]
            errs.append(float(((y[r, b].double() - q.double()) ** 2).sum()))
        if abs(errs[0] - errs[1]) > TIE_RTOL * max(errs):
            fail(f"phase 14: the probe's kernel and plain encodes select codebooks "
                 f"{int(ksel[r, b])} and {int(psel[r, b])} for block ({r}, {b}), no tie: {errs}")
    return len(diff)


def hold_probe_launches(rec):
    """From here on every probe launch of B3 (one a site: ``rec.record``) is
    held to the plain ``encode_stats`` on the same x: NMSE within
    PROBE_NMSE_RTOL, occupancy equal except on codebook ties
    (``probe_ties``).  Returns the running tally; ``del rec.record`` ends
    it.  It reads each launch back at once: for an eager check run."""
    from repro_torch.core import bcq

    tally = {"launches": 0, "tie_blocks": 0, "worst_nmse_rel": 0.0}
    real = rec.record

    def record(site, x, codebooks, cfg):
        k = rec._k
        real(site, x, codebooks, cfg)
        pn, po = bcq.encode_stats_plain(x, codebooks, cfg)
        kn, pn = float(rec.nmse[k]), float(pn)
        rel = abs(kn - pn) / max(pn, 1e-30)
        tally["launches"] += 1
        tally["worst_nmse_rel"] = max(tally["worst_nmse_rel"], rel)
        if rel > PROBE_NMSE_RTOL:
            fail(f"phase 14: probe launch {tally['launches']} ({site}): kernel NMSE {kn!r}, "
                 f"plain {pn!r}")
        if rec.occupancy[k].tolist() != po.tolist():
            n = probe_ties(x, codebooks, cfg)
            if n == 0:
                fail(f"phase 14: probe launch {tally['launches']} ({site}): occupancy "
                     f"{rec.occupancy[k].tolist()} vs plain {po.tolist()} with equal selectors")
            tally["tie_blocks"] += n

    rec.record = record
    return tally


def check_telemetry_files(*paths):
    """``tools/check_telemetry.py`` on a metrics dump (and a trace)."""
    check = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "check_telemetry.py"),
                            *paths], capture_output=True, text=True, timeout=120)
    print(f"phase 14 tools/check_telemetry.py (exit {check.returncode}): "
          f"{(check.stdout + check.stderr).strip()}", flush=True)
    if check.returncode != 0:
        fail(f"phase 14: tools/check_telemetry.py rejects {paths}")


def time_probe(cb):
    """B3's probe form: ``bcq.encode_stats`` at decode (8 rows: the slots)
    for K 768 (attn_qkv, attn_out, mlp_in) and 3072 (mlp_out) — event-loop
    ms of the whole probe, B3's device time in it (the mean of the profiler
    events it got) and the probe's device ms, the plain ``encode_stats`` and
    the bound of B3's encode at that shape."""
    from repro_torch.core import bcq

    cfg = bcq.BCQConfig()
    out = {}
    for m, k, seed in ((8, 768, 71), (8, 3072, 72)):
        x = activation(m, k, seed)
        ms = cuda_ms(lambda: bcq.encode_stats(x, cb, cfg))
        plain_ms = cuda_ms(lambda: bcq.encode_stats_plain(x, cb, cfg), iters=10)
        nbytes = m * k * 4 + m * k // 2 + m * k // 16 + m * k // 64 * 4 + 8 * 16 * 4 + 4
        bound, by = _bound(nbytes, (ENCODE_OPS * m * k, F32_FLOPS))
        iters = 20
        for _ in range(3):
            got = _device_kernels(lambda: bcq.encode_stats(x, cb, cfg), iters)
            if got is None:
                continue
            n_kern, probe_dev, by_name, seen = got
            enc = [nm for nm in by_name if "encode_kernel" in nm]
            if len(enc) == 1 and seen[enc[0]] >= iters / 2:
                dev = by_name[enc[0]] * iters / seen[enc[0]]
                if dev >= bound:
                    break
        else:
            fail(f"phase 14: torch.profiler lost B3's probe launches at M={m} K={k}")
        out[k] = {"shape": f"M {m} K {k} (decode probe)", "ms": ms, "device_ms": dev,
                  "probe_device_ms": probe_dev, "probe_kernels": n_kern, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": None}
        print(f"B3 probe form (encode_stats) at M={m} K={k}: {ms:.4f} ms a probe (event loop), "
              f"B3's encode {dev:.4f} ms device, the probe's {n_kern:.0f} kernels {probe_dev:.4f} ms "
              f"device (torch.profiler), plain encode_stats {plain_ms:.4f} ms, B3 bound "
              f"{bound:.5f} ms by {by}", flush=True)
    return {**out[768], "at_k3072": out[3072]}


def phase_telemetry(eng4, cb, g2, core_g2, smi):
    """Phase 14: telemetry on the card.  Phase 11's workload at graph depth
    2 at the "counters" level, held bit for bit to phase 12's run (which
    has the default level: histograms, timelines, journal): equal
    device_syncs; that run's TTFT and ITL counts, and its metrics and
    trace accepted by ``tools/check_telemetry.py``.  Phase 4's workload on
    a counters-level engine beside phase 12's default one: the same graph
    nodes, bits and device_syncs, 1 ``cudaGraphLaunch`` and 0 host kernel
    launches a steady tick.  Quant-error probes (``--quant-probes``): phase
    11's workload eagerly at depth 1, every probe launch of B3 held to the
    plain ``encode_stats``, and at graph depth 2 — equal probe reports bit
    for bit, the tokens of phase 12, 48 B3 launches a pass; the probe
    engine's graph and steady tick on phase 4's workload; B3's probe form
    timed.  Returns (launch counts of the phase's runs, B3's probe-form
    entry)."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.serving.telemetry import Telemetry

    cfg = get_arch("gpt3_126m")
    api_k, params = eng4.api, eng4.params
    way12, eng12 = core_g2
    total = {}

    def add(counts):
        for n in COUNTED + ("bcq_quantize",):
            total[n] = total.get(n, 0) + counts.get(n, 0)

    def syncs(eng):
        return eng.telemetry.registry.counter("device_syncs").value

    # the counters level against phase 12's default level, phase 11's workload
    fin_c, eng_c, _, counts_c = drive_core(api_k, params, core_requests(cfg), cuda_graphs=True,
                                           pipeline_depth=2, telemetry=Telemetry("counters"))
    way_c = {"out": _outcome(eng_c, fin_c), "counts": counts_c, "pool": eng_c.final_pool}
    _hold_ways([("phase 12 graph depth 2 (default level)", way12), ("counters level", way_c)],
               "phase 11's workload", "phase 14")
    if syncs(eng12) != syncs(eng_c) or not syncs(eng12):
        fail(f"phase 14: device_syncs {syncs(eng12)} at the default level, {syncs(eng_c)} at "
             "the counters level")
    if len(eng_c.telemetry.timelines) or len(eng_c.telemetry.journal):
        fail("phase 14: the counters level recorded timelines or journal events")
    tel = eng12.telemetry
    n_fin, n_tok = len(eng12.finished), sum(len(r.out) for r in eng12.finished)
    if tel.h_ttft.count != n_fin or tel.h_itl.count != n_tok - n_fin:
        fail(f"phase 14: TTFT count {tel.h_ttft.count} for {n_fin} finished requests, ITL count "
             f"{tel.h_itl.count} for {n_tok - n_fin} tokens after each request's first")
    metrics = os.path.join(ROOT, "build", "telemetry_metrics.json")
    trace = os.path.join(ROOT, "build", "telemetry_trace.json")
    tel.dump_metrics(metrics, engine=eng12)
    tel.dump_trace(trace)
    check_telemetry_files(metrics, trace)
    hs = tel.registry.snapshot()["histograms"]
    ms = lambda h: f"mean {hs[h]['mean'] * 1e3:.3f} ms (n={hs[h]['count']})"  # noqa: E731
    print(f"phase 14 phase 11's workload, graph depth 2: the counters level ≡ phase 12's default "
          f"level bit for bit (tokens, margins, launch indices, counters, pool bytes, launch "
          f"counts); device_syncs {syncs(eng12)} at both levels; default level: TTFT "
          f"{ms('ttft_s')}, ITL {ms('itl_s')}, queue {ms('queue_time_s')}, prefill launch "
          f"{ms('prefill_launch_s')}, decode tick {ms('decode_tick_s')}, decode sync "
          f"{ms('decode_sync_s')}, decode host gap {ms('decode_host_gap_s')}; journal "
          f"{len(tel.journal)} events ({tel.journal.dropped} dropped): "
          f"{tel.journal.counts()}", flush=True)
    add(counts_c)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    wc = production_way(eng4, prompts, True, 2, 10, label="phase 14 counters level",
                        telemetry=Telemetry("counters"))
    _hold_ways([("phase 12 graph depth 2 (default level)", g2), ("counters level", wc)],
               "phase 4's workload", "phase 14")
    for name, w in (("default", g2), ("counters", wc)):
        if w["prof"] is None or w["prof"][2] != 0 or w["prof"][3] != 1:
            fail(f"phase 14: the {name} level's steady greedy tick: {w['prof']}")
    if wc["nodes"] != g2["nodes"] or not wc["nodes"] or syncs(wc["engine"]) != syncs(g2["engine"]):
        fail(f"phase 14: the counters level's decode graph ({wc['nodes']} nodes, "
             f"{syncs(wc['engine'])} syncs) is not the default level's ({g2['nodes']}, "
             f"{syncs(g2['engine'])})")
    print(f"phase 14 phase 4's workload, graph depth 2: default level (phase 12's engine) and "
          f"counters level equal bit for bit; decode graph nodes {g2['nodes']} at both (an "
          f"earlier run: {EARLIER_DEFAULT_TICK[0]}); 1 cudaGraphLaunch and 0 host kernel launches "
          f"a steady tick at both; device_syncs {syncs(g2['engine'])} at both; steady tick wall "
          f"default {g2['wall']:.2f} ms, counters {wc['wall']:.2f} ms (an earlier run: "
          f"{EARLIER_DEFAULT_TICK[1]} ms); card {smi}", flush=True)
    add(wc["counts"])

    api_p, rec = probe_model(api_k)
    passes = lambda eng: eng.stats["decode_ticks"] + eng.stats["prefill_launches"]  # noqa: E731
    per_pass = len(PROBE_SITES) * cfg.n_layers
    sink_e, log_e = attach_sink(rec, cfg)
    tally = hold_probe_launches(rec)
    try:
        fin_e, eng_e, _, counts_e = drive_core(api_p, params, core_requests(cfg))
    finally:
        del rec.record
    sink_g, log_g = attach_sink(rec, cfg)
    fin_g, eng_g, _, counts_g = drive_core(api_p, params, core_requests(cfg), cuda_graphs=True,
                                           pipeline_depth=2)
    for name, eng, counts in (("eager depth 1", eng_e, counts_e),
                              ("graph depth 2", eng_g, counts_g)):
        core_counts(eng, counts, f"phase 14 probes {name}")
        if counts.get("bcq_quantize", 0) != per_pass * passes(eng):
            fail(f"phase 14: B3 launched {counts.get('bcq_quantize', 0)} times for the probes of "
                 f"{passes(eng)} passes ({name}), expected {per_pass} a pass")
    if tally["launches"] != per_pass * passes(eng_e):
        fail(f"phase 14: {tally['launches']} probe launches held, expected {per_pass * passes(eng_e)}")
    rep_e, rep_g = sink_e.report(), sink_g.report()
    if rep_e != rep_g or log_e != log_g:
        fail("phase 14: the probe reports of graph depth 2 and eager depth 1 differ")
    if set(rep_g["sites"]) != set(PROBE_SITES) or any(
            set(per) != {str(i) for i in range(cfg.n_layers)} or
            any(a["count"] != passes(eng_g) for a in per.values())
            for per in rep_g["sites"].values()):
        fail(f"phase 14: probe report sites/layers/counts: {rep_g['sites'].keys()}")
    strip = lambda c: {n: c.get(n, 0) for n in COUNTED}  # noqa: E731
    _hold_ways([("phase 12 graph depth 2", dict(way12, counts=strip(way12["counts"]))),
                ("probes eager depth 1", {"out": _outcome(eng_e, fin_e), "pool": eng_e.final_pool,
                                          "counts": strip(counts_e)}),
                ("probes graph depth 2", {"out": _outcome(eng_g, fin_g), "pool": eng_g.final_pool,
                                          "counts": strip(counts_g)})],
               "phase 11's workload with probes", "phase 14")
    pmetrics = os.path.join(ROOT, "build", "telemetry_probe_metrics.json")
    eng_g.telemetry.dump_metrics(pmetrics, engine=eng_g, probe_sink=sink_g)
    check_telemetry_files(pmetrics)
    means = sorted(((a["nmse_mean"], s, la) for s, per in rep_g["sites"].items()
                    for la, a in per.items()), reverse=True)
    occ = np.sum([a["cluster_occupancy"] for per in rep_g["sites"].values()
                  for a in per.values()], axis=0)
    print(f"phase 14 quant-error probes, phase 11's workload: eager depth 1 and graph depth 2 "
          f"reports equal bit for bit ({rep_g['emissions']} emissions, {len(rep_g['sites'])} sites "
          f"× {rep_g['n_layers']} layers); B3 launched {per_pass} times a pass "
          f"({counts_g['bcq_quantize']} at graph depth 2); every one of the {tally['launches']} "
          f"eager probe launches held to the plain encode_stats (worst NMSE rel. difference "
          f"{tally['worst_nmse_rel']:.2e}, tol {PROBE_NMSE_RTOL}; {tally['tie_blocks']} tie "
          f"blocks); tokens, margins, launch indices, counters and pool bytes of phase 12; "
          f"NMSE means {means[-1][0]:.3e}–{means[0][0]:.3e} over (site, layer), worst "
          + ", ".join(f"{s}/L{la} {m:.3e}" for m, s, la in means[:3])
          + f"; codebook occupancy over the run {occ.tolist()}", flush=True)
    add(counts_e)
    add(counts_g)

    attach_sink(rec, cfg)
    wp = production_way(eng4, prompts, True, 2, 10, label="phase 14 probes", api=api_p)
    if wp["out"] != g2["out"] or not _same_pool(wp["pool"], g2["pool"]):
        fail("phase 14: the probe engine's tokens or pool bytes differ from phase 12's")
    if wp["prof"] is None or wp["prof"][2] != 0 or wp["prof"][3] != 1:
        fail(f"phase 14: the probe engine's steady tick: {wp['prof']}")
    wp_passes = wp["out"][1]["decode_ticks"] + wp["out"][1]["prefill_launches"]
    if wp["counts"].get("bcq_quantize", 0) != per_pass * wp_passes:
        fail(f"phase 14: B3 launched {wp['counts'].get('bcq_quantize', 0)} times for the probes "
             "of phase 4's workload")
    print(f"phase 14 probes on phase 4's workload, graph depth 2: decode graph nodes {wp['nodes']} "
          f"(default {g2['nodes']}); steady tick wall {wp['wall']:.2f} ms (default "
          f"{g2['wall']:.2f}), {_profile_txt(wp['prof'], wp['wall'])}; card {smi}", flush=True)
    add(wp["counts"])
    return total, time_probe(cb)


# ------------------------------------------------------------------ phase 15
# The host tier on phase 11's engine, its schedule chosen in a CPU rehearsal
# (the schedule does not depend on the tokens; PERF.md §6 has the predicted
# counts): 32 host pages, few enough that the tier's own LRU eviction fires,
# and two more waves once phase 11's requests have drained — 6 prompts of 224
# unrelated tokens (16 tokens each), whose pages push the parked pages of
# the shared prefix out to the tier, then the shared 320-token prefix again
# with 20, 30 and 40 new suffix tokens, which finds it there.
TIER_PAGES = 32
TIER_FILL = (6, 224, 16)  # filler prompts: count, tokens, tokens generated
TIER_AGAIN = (20, 30, 40)  # suffix tokens of the prefix resubmissions
TIER_SEED = 15
TIER_CHAOS_SEED = 1  # the CLI chaos run with --host-tier: a corrupt swap-in among its faults
PAGE_BYTES = 12 * 2 * 16 * 12 * (32 + 4 + 1)  # a bcq4 page: layers × (K, V) × tokens × heads × bytes
PCIE_BPS = 64e9  # the host link, PCIe Gen5 x16: nominal bytes/s each direction
LADDER_ROUNDS, LADDER_BUDGET = 3, 8  # forced ladder ticks, pages a tick


def tier_waves(cfg):
    """Phase 15's two later waves (rids 20–25, then 30–32)."""
    from repro_torch.serving.generate import Request

    rng = np.random.default_rng(TIER_SEED)
    prefix = core_requests(cfg)[0].prompt[:CORE_PREFIX]
    n, plen, gen = TIER_FILL
    fill = [Request(rid=20 + i, prompt=rng.integers(0, cfg.vocab, plen), max_new=gen - 1)
            for i in range(n)]
    again = [Request(rid=30 + i, prompt=np.concatenate([prefix, rng.integers(0, cfg.vocab, k)]),
                     max_new=GEN - 1) for i, k in enumerate(TIER_AGAIN)]
    return [fill, again]


def _bits(t):
    return t.contiguous().reshape(-1).view(__import__("torch").uint8)


def tier_probe(rec):
    """A ``drive_core`` setup on a host-tier engine: each swap-out's copy
    (CUDA events) and digest + put (host clock) timed and its fetched
    arrays kept by handle; each swap-in's take + verify (host clock) and
    copy (events) timed, and the page's bytes after the insert held to the
    arrays fetched at its swap-out, bit for bit; the tick and launch of
    every carry and of every resume from host."""
    import torch

    from repro_torch.serving import pages as pages_lib

    for k in ("out_copy_ms", "out_put_ms", "in_take_ms", "in_copy_ms", "carry", "resume",
              "corrupt"):
        rec[k] = []
    rec["fetched"], rec["held"] = {}, 0

    def setup(eng):
        tier, pending = eng.host_tier, {}
        fetch, put, take, corrupt = eng._fetch_page_arrays, tier.put, tier.take, tier.corrupt
        insert, carry, resume = (eng._insert_page_arrays, eng._carry_resume_state,
                                 eng._try_resume_from_host)

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def _fetch(pid):
            a = event()
            out = fetch(pid)
            b = event()
            b.synchronize()
            rec["out_copy_ms"].append(a.elapsed_time(b))
            pending["arrays"] = [t.clone() for t in out]
            return out

        def _put(arrays, *a, **kw):
            t0 = time.perf_counter()
            handle = put(arrays, *a, **kw)
            rec["out_put_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["fetched"][handle] = pending.pop("arrays")
            return handle

        def _take(handle, *a, **kw):
            pending["handle"] = handle
            t0 = time.perf_counter()
            try:
                return take(handle, *a, **kw)
            finally:
                rec["in_take_ms"].append((time.perf_counter() - t0) * 1e3)

        def _insert(pid, entry):
            a = event()
            insert(pid, entry)
            b = event()
            b.synchronize()
            rec["in_copy_ms"].append(a.elapsed_time(b))
            want = rec["fetched"].pop(pending.pop("handle"))
            got = pages_lib.kv_page_fetch(eng.pool, pid)
            if len(got) != len(want) or not all(torch.equal(_bits(g), _bits(w))
                                                for g, w in zip(got, want)):
                fail(f"phase 15: page {pid} after its swap-in differs from the bytes fetched "
                     "at its swap-out")
            rec["held"] += 1

        def _corrupt(handle, *a, **kw):
            rec["corrupt"].append((eng._tick, eng._launches))
            return corrupt(handle, *a, **kw)

        def _carry(i, resumed):
            carry(i, resumed)
            if resumed._host_resume is not None:
                rec["carry"].append((eng._tick, int(resumed.rid), eng._launches,
                                     len(resumed._host_resume[0])))

        def _resume(req, slot_idx, hr):
            res = resume(req, slot_idx, hr)
            if res:
                rec["resume"].append((eng._tick, int(req.rid), eng._launches, len(hr[0])))
            return res

        eng._fetch_page_arrays, eng._insert_page_arrays = _fetch, _insert
        eng._carry_resume_state, eng._try_resume_from_host = _carry, _resume
        tier.put, tier.take, tier.corrupt = _put, _take, _corrupt

    return setup


def resume_timer(rec):
    """A ``drive_core`` setup that only times each resume from host, on the
    host clock with the stream synchronized before and after (no other
    wrapper: the swaps themselves run as in production)."""
    import torch

    rec["resume"] = []

    def setup(eng):
        resume = eng._try_resume_from_host

        def _resume(req, slot_idx, hr):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = resume(req, slot_idx, hr)
            torch.cuda.synchronize()
            if res:
                rec["resume"].append((int(req.rid), (time.perf_counter() - t0) * 1e3, len(hr[0])))
            return res

        eng._try_resume_from_host = _resume

    return setup


def _instants(eng, name):
    return [args for kind, nm, _, _, _, _, args, _ in eng.telemetry.journal._buf
            if kind == "instant" and nm == name]


def drive_tier(api, params, what, setup=None, faults=None, allow_errors=False, **mode):
    """Phase 11's engine with a host tier of ``TIER_PAGES`` pages over phase
    11's requests and phase 15's two later waves (eager at depth 1 unless
    ``mode`` says otherwise).  Checks every request finished, the swap
    accounting, a clean strict audit (the cross-tier partition included)
    and the page accounting after the drain.  Returns (finished by (rid,
    sample_idx), engine, the way's record for ``_hold_ways``, launch
    counts, the step trace)."""
    cfg = api.cfg
    fin, eng, trace, counts = drive_core(api, params, core_requests(cfg), setup=setup,
                                         waves=tier_waves(cfg), allow_errors=allow_errors,
                                         host_pages=TIER_PAGES, fault_injector=faults, **mode)
    want = sorted([(r, 0) for r in range(CORE_REQUESTS)] + [(CORE_FORK, 1), (CORE_SAMPLED, 1),
                  (CORE_SAMPLED, 2)] + [(20 + i, 0) for i in range(TIER_FILL[0])]
                  + [(30 + i, 0) for i in range(len(TIER_AGAIN))])
    if sorted(fin) != want:
        fail(f"phase 15 [{what}]: finished {sorted(fin)}, expected {want}")
    sw = {k: c.value for k, c in eng._cs_swap.items()}
    if sw["swap_ins"] != sw["verified_swapins"] + sw["corrupt_swapins"]:
        fail(f"phase 15 [{what}]: swap accounting {sw}")
    eng.audit(strict=True)
    core_clean(eng, f"phase 15 {what}")
    kinds = {k: r.error.kind for k, r in fin.items() if r.error is not None}
    out = (*_outcome(eng, fin), kinds, sw, eng.host_tier.snapshot(), eng.prefix.host_hits)
    return fin, eng, {"out": out, "counts": counts, "pool": eng.final_pool}, counts, trace


def _recompute_ms(req):
    """The recompute of a preempted request in a tier-off run: (the summed
    prefill launches its prompt rode after its last admission, the wall from
    that admission to the end of the last), ms."""
    tl = req.timeline
    spans = [(t0, t1) for t0, t1 in tl.prefill_spans if t0 >= tl.admits[-1]]
    if not spans:
        return None
    return (1e3 * sum(t1 - t0 for t0, t1 in spans), 1e3 * (spans[-1][1] - tl.admits[-1]))


def _ms(v):
    return f"{np.mean(v):.4f} (min {np.min(v):.4f}, n {len(v)})" if v else "none"


def time_swap(eng, smi):
    """One bcq4 page's swap-out and swap-in on an idle stream, 50 times
    each: the copies by CUDA events, the host's digest + put and take +
    verify by the host clock; beside the copy's bound at PCIe Gen5 x16."""
    import torch

    from repro_torch.serving import pages as pages_lib

    pid = 1
    tier = pages_lib.HostPageTier(2)
    d2h, h2d, put, take = [], [], [], []
    for _ in range(50):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        arrays = pages_lib.kv_page_fetch(eng.pool, pid)
        b.record()
        b.synchronize()
        d2h.append(a.elapsed_time(b))
        t0 = time.perf_counter()
        handle = tier.put(arrays, "kv")
        t1 = time.perf_counter()
        entry = tier.take(handle)
        t2 = time.perf_counter()
        put.append((t1 - t0) * 1e3)
        take.append((t2 - t1) * 1e3)
        a.record()
        pages_lib.kv_page_insert(eng.pool, entry.arrays, pid, flat=entry.flat)
        b.record()
        b.synchronize()
        h2d.append(a.elapsed_time(b))
    # the copies' own device time: torch.profiler over 10 calls of each
    dev_out = _device_kernels(lambda: pages_lib.kv_page_fetch(eng.pool, pid), 10)
    dev_in = _device_kernels(lambda: pages_lib.kv_page_insert(eng.pool, entry.arrays, pid,
                                                              flat=entry.flat), 10)
    bound = PAGE_BYTES / PCIE_BPS * 1e3

    def dev_txt(d):
        if d is None:
            return "device time not measured (the profiler saw no event)"
        kern, busy, by_name, _ = d
        move = sum(ms for nm, ms in by_name.items() if nm.startswith("Memcpy"))
        return (f"{busy:.4f} ms of device time a call in {kern:.0f} events: the transfer "
                f"{move:.4f}, the slices' copy kernels {busy - move:.4f}")

    print(f"phase 15 one bcq4 page ({entry.nbytes} B) on an idle stream, 50 times: swap-out "
          f"copy (gather + device→host) {_ms(d2h)} ms between CUDA events (host-paced), "
          f"{dev_txt(dev_out)}; digest + put (host) {_ms(put)} ms; swap-in take + verify "
          f"(host) {_ms(take)} ms, copy (host→device + scatter) {_ms(h2d)} ms between events, "
          f"{dev_txt(dev_in)}; the copy's bound at 64 GB/s (PCIe Gen5 x16, nominal) "
          f"{bound * 1e3:.2f} µs; card {smi}", flush=True)
    if entry.nbytes != PAGE_BYTES:
        fail(f"phase 15: a bcq4 page is {entry.nbytes} B, expected {PAGE_BYTES}")
    return {"d2h_ms": float(np.mean(d2h)), "h2d_ms": float(np.mean(h2d)),
            "d2h_device_ms": None if dev_out is None else dev_out[1],
            "h2d_device_ms": None if dev_in is None else dev_in[1],
            "put_ms": float(np.mean(put)), "take_ms": float(np.mean(take)), "bound_ms": bound}


def ladder_probe(rec):
    """A ``drive_core`` setup: every recompressed page's bytes after the
    ladder step held to the CPU's ``_fake_quant`` of the bytes fetched just
    before it, bit for bit (integer leaves unchanged)."""
    import torch

    from repro_torch.serving import pages as pages_lib

    rec["pages"], rec["stages"] = 0, {}

    def setup(eng):
        real = eng._recompress_page

        def _recompress(pid, stage):
            before = pages_lib.kv_page_fetch(eng.pool, pid)
            real(pid, stage)
            after = pages_lib.kv_page_fetch(eng.pool, pid)
            levels = pages_lib._STAGE_LEVELS[stage]
            for b, a in zip(before, after):
                want = pages_lib._fake_quant(b.clone(), levels) if b.is_floating_point() else b
                if not torch.equal(_bits(a), _bits(want)):
                    fail(f"phase 15: page {pid} at stage {stage} differs from the CPU "
                         "_fake_quant of its bytes")
            rec["pages"] += 1
            rec["stages"][stage] = rec["stages"].get(stage, 0) + 1

        eng._recompress_page = _recompress

    return setup


def phase_host_tier(eng4, tol, core, g2, core_g2, smi):
    """Phase 15: the host tier on the card — phase 11's engine with 32 host
    pages over phase 11's requests and two later waves.  Through the
    kernels at graph depth 2 (every swap-in held bit for bit to the bytes
    of its swap-out, the swaps timed) and eagerly at depth 1: equal bit
    for bit (tokens, margins, launch indices, counters, swap counters, tier
    snapshot, pool bytes, launch counts); every launch of a graph depth 2
    run held to the plain paths (``check_shadow``), the first decode
    launch after each resume from host among them; a corrupt swap-in
    quarantines its owner alone; a refused carry recomputes; audits clean;
    the CLI's chaos run with the tier passes ``tools/check_chaos.py``; an
    idle tier keeps phase 12's steady tick; the ladder on a bf16 pool
    equals the CPU's ``_fake_quant``.  Returns the launch counts of its
    kernel runs."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import zoo
    from repro_torch.serving.faults import FaultInjector

    cfg = get_arch("gpt3_126m")
    api_p = core[0]
    api_k, params = eng4.api, eng4.params
    total = {}

    def add(c):
        for n in COUNTED:
            total[n] = total.get(n, 0) + c.get(n, 0)

    rec = {}
    t0 = time.perf_counter()
    fin_g, eng_g, way_g, counts_g, trace_g = drive_tier(
        api_k, params, "graph depth 2", setup=tier_probe(rec), cuda_graphs=True, pipeline_depth=2)
    run_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    fin_e, eng_e, way_e, counts_e, trace_e = drive_tier(api_k, params, "eager depth 1")
    run_e = time.perf_counter() - t0
    _hold_ways([("eager depth 1", way_e), ("graph depth 2", way_g)], "phase 15's workload",
               "phase 15")
    if trace_g != trace_e:
        fail("phase 15: the graph depth 2 run's steps differ from eager depth 1's")
    for name, eng, counts in (("graph depth 2", eng_g, counts_g), ("eager depth 1", eng_e,
                                                                   counts_e)):
        core_counts(eng, counts, f"phase 15 {name}")
    add(counts_g)
    add(counts_e)
    sw, snap, host_hits = way_g["out"][3], way_g["out"][4], way_g["out"][5]
    resumes = _instants(eng_g, "swap_resume")
    st = {k: eng_g.stats[k] for k in CORE_STATS}
    if not (sw["swap_outs"] and host_hits and resumes and _instants(eng_g, "host_evict")
            and rec["resume"] and rec["held"] == sw["verified_swapins"] == sw["swap_ins"]):
        fail(f"phase 15: the run must demote parked pages, hit them from host, resume a "
             f"preempted request from host and evict from the tier: swap {sw}, host hits "
             f"{host_hits}, resumes {resumes}, held {rec['held']}")
    for _, rid, _, _ in rec["resume"]:
        tl = fin_g[(rid, 0)].timeline
        if any(t0 >= tl.admits[-1] for t0, _ in tl.prefill_spans):
            fail(f"phase 15: request {rid} resumed from host but prefilled its prompt again")
    print(f"phase 15 host tier ({TIER_PAGES} host pages; card {smi}): graph depth 2 "
          f"{run_g:.2f} s (every swap timed and checked), eager depth 1 {run_e:.2f} s; "
          f"{eng_g._tick} ticks, {eng_g.stats['decode_ticks']} decode ticks, "
          f"{eng_g.stats['prefill_launches']} prefill launches; counters {st}; swap {sw}; tier "
          f"{snap}; prefix host hits {host_hits}; host_evict {len(_instants(eng_g, 'host_evict'))}"
          f", carries {rec['carry']}, resumes from host {resumes}; the two ways equal bit for "
          f"bit (tokens, margins, launch indices, counters, swap counters, tier snapshot, pool "
          f"bytes, launch counts {counts_g}); every one of the {rec['held']} swap-ins equal to "
          f"the bytes of its swap-out; audits clean", flush=True)
    print(f"phase 15 swaps in the graph depth 2 run: swap-out copy (between CUDA events, "
          f"host-paced) {_ms(rec['out_copy_ms'])} ms, digest + put (host) "
          f"{_ms(rec['out_put_ms'])} ms; swap-in take + verify (host) "
          f"{_ms(rec['in_take_ms'])} ms, copy (between events) {_ms(rec['in_copy_ms'])} ms; bytes a page {PAGE_BYTES}, the copy's bound at 64 GB/s "
          f"{PAGE_BYTES / PCIE_BPS * 1e6:.2f} µs; card {smi}", flush=True)

    # the resume, timed on a run with no other wrapper, against the tier-off
    # recompute of the same request (phase 12's graph depth 2 run of phase
    # 11's workload)
    rec_t = {}
    fin_t, eng_t, way_t, counts_t, _ = drive_tier(api_k, params, "graph depth 2, timed",
                                                  setup=resume_timer(rec_t), cuda_graphs=True,
                                                  pipeline_depth=2)
    add(counts_t)
    _hold_ways([("graph depth 2", way_g), ("graph depth 2, timed", way_t)],
               "phase 15's workload", "phase 15")
    eng_off = core_g2[1]
    fin_off = {(r.rid, r.sample_idx): r for r in eng_off.finished}
    resume_vs = []
    for rid, ms, pages in rec_t["resume"]:
        off = _recompute_ms(fin_off[(rid, 0)]) if (rid, 0) in fin_off else None
        resume_vs.append({"rid": rid, "pages": pages, "resume_ms": ms,
                          "recompute_prefill_ms": None if off is None else off[0],
                          "recompute_wall_ms": None if off is None else off[1]})
        print(f"phase 15 request {rid}'s re-admission after its preemption: from host {ms:.3f} "
              f"ms ({pages} pages: take + verify, copy, host clock synchronized before and "
              f"after); in the tier-off run (phase 12's graph depth 2) "
              + ("no recompute" if off is None else
                 f"its recompute's prefill launches {off[0]:.3f} ms, {off[1]:.3f} ms from "
                 "re-admission to the end of its prompt")
              + f"; card {smi}", flush=True)

    # every launch held to the plain paths on its own inputs
    log = check_shadow(api_k, api_p, params, core_requests(cfg), fin_g, tol,
                       "host tier, graph depth 2", ("sampled", "resumed", "fork", "cow"),
                       cuda_graphs=True, pipeline_depth=2, host_pages=TIER_PAGES,
                       waves=tier_waves(cfg))
    for _, rid, launch, _ in rec["resume"]:
        if not any(kind == "decode" and e0 >= launch and any(k == (rid, 0) for k, *_ in toks)
                   for e0, kind, _, toks, _ in log):
            fail(f"phase 15: no decode launch after request {rid}'s resume was shadowed")

    # a corrupt swap-in quarantines its owner alone
    tick, rid = rec["resume"][0][0], rec["resume"][0][1]
    rec_c = {}
    fin_c, eng_c, way_c, counts_c, _ = drive_tier(
        api_k, params, "corrupt swap-in", setup=tier_probe(rec_c), allow_errors=True,
        faults=FaultInjector(seed=0, schedule=[(tick, "swap_corrupt", rid)], max_faults=1),
        cuda_graphs=True, pipeline_depth=2)
    add(counts_c)
    kinds = way_c["out"][2]
    launch = rec_c["corrupt"][0][1] if rec_c["corrupt"] else None
    if kinds != {(rid, 0): "quarantined"} or "integrity" not in str(fin_c[(rid, 0)].error) \
            or way_c["out"][3]["corrupt_swapins"] != 1 or launch is None:
        fail(f"phase 15: the corrupt swap-in (tick {tick}, request {rid}) gave errors {kinds}, "
             f"swap {way_c['out'][3]}")
    for key, r in fin_c.items():
        ref = fin_g[key]
        before = [(t, lid) for t, lid in zip(r.out, r.launch_ids) if lid < launch]
        if before != [(t, lid) for t, lid in zip(ref.out, ref.launch_ids) if lid < launch]:
            fail(f"phase 15: request {key}'s tokens before the corrupt swap-in's launch {launch} "
                 "differ from the run without the fault")
    print(f"phase 15 swap_corrupt at tick {tick} on request {rid}'s resume: only it quarantined "
          f"({fin_c[(rid, 0)].error}); every request's tokens before launch {launch} equal the "
          f"clean run's; swap {way_c['out'][3]}", flush=True)

    # a refused carry recomputes
    tick_o, rid_o = rec["carry"][0][0], rec["carry"][0][1]
    fin_r, eng_r, way_r, counts_r, _ = drive_tier(
        api_k, params, "refused swap-out",
        faults=FaultInjector(seed=0, schedule=[(tick_o, "swap_out", rid_o)], max_faults=1),
        cuda_graphs=True, pipeline_depth=2)
    add(counts_r)
    tl = fin_r[(rid_o, 0)].timeline
    if way_r["out"][3]["swap_skips"] < 1 or any(a["rid"] == rid_o for a in
                                               _instants(eng_r, "swap_resume")) \
            or not any(t0 >= tl.admits[-1] for t0, _ in tl.prefill_spans):
        fail(f"phase 15: the refused carry of request {rid_o} at tick {tick_o} did not "
             f"recompute: swap {way_r['out'][3]}")
    print(f"phase 15 swap_out refused at tick {tick_o} (request {rid_o}'s carry): it recomputed "
          f"its prompt, every request finished clean; swap {way_r['out'][3]}", flush=True)

    # the CLI's chaos run with the tier
    prompts = list(np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)))
    path = os.path.join(ROOT, "build", "chaos_report_host_tier.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    from repro_torch.kernels import build

    build.reset_counts()
    rep = serve.run_chaos(api_k, params, prompts, 16, seed=TIER_CHAOS_SEED, report_path=path,
                          host_pages=256)
    torch.cuda.synchronize()
    add(build.counts())
    check = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "check_chaos.py"), path],
                           capture_output=True, text=True, timeout=120)
    csw = rep["health"]["swap"]
    print(f"phase 15 tools/check_chaos.py on the --host-tier chaos report (exit "
          f"{check.returncode}): {(check.stdout + check.stderr).strip()}", flush=True)
    if check.returncode != 0 or not rep["host_tier"] or not csw["swap_outs"] \
            or csw["swap_ins"] != csw["verified_swapins"] + csw["corrupt_swapins"]:
        fail(f"phase 15: the host-tier chaos report fails: {rep['host_tier']}, swap {csw}")
    rep1 = serve.run_chaos(api_k, params, prompts, 16, seed=TIER_CHAOS_SEED, host_pages=256,
                           pipeline_depth=1, cuda_graphs=False)
    key = lambda r: (sorted((o["rid"], o["sample_idx"], o["error_kind"], o["n_out"])  # noqa: E731
                            for o in r["requests"]), r["faults"]["by_site"], r["ticks"],
                     r["health"]["counters"], r["health"]["swap"], r["health"]["host_tier"])
    if key(rep) != key(rep1):
        fail(f"phase 15: the host-tier chaos run at graph depth 2 and eagerly at depth 1 "
             f"differ: {key(rep)} vs {key(rep1)}")

    # an idle tier costs the steady tick nothing
    rng = np.random.default_rng(0)
    prompts4 = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    w = production_way(eng4, prompts4, True, 2, 10, label="phase 15", host_pages=TIER_PAGES)
    _hold_ways([("phase 12 graph depth 2", g2), ("idle host tier", w)], "phase 4's workload",
               "phase 15")
    prof = w["prof"]
    if w["nodes"] != g2["nodes"] or not w["nodes"] or prof is None or prof[2] != 0 \
            or prof[3] != 1 or w["engine"].health()["swap"]["swap_outs"]:
        fail(f"phase 15: the idle tier's steady tick (graph nodes {w['nodes']}; {prof}) is not "
             f"phase 12's ({g2['nodes']}; {g2['prof']})")
    add(w["counts"])
    print(f"phase 15 idle tier ({TIER_PAGES} host pages, no pressure) on phase 4's workload: "
          f"graph nodes {w['nodes']} (phase 12's {g2['nodes']}), steady tick wall {w['wall']:.2f} "
          f"ms (phase 12's {g2['wall']:.2f}), {_profile_txt(prof, w['wall'])}; card {smi}",
          flush=True)

    # the ladder on a bf16 pool: phase 11's requests leave parked pages, then
    # the pressure signal is held at 0 for LADDER_ROUNDS ladder ticks
    api_b = zoo.build(cfg, dataclasses.replace(api_k.rt, cache_kind="bf16"), device="cuda")
    rec_l = {}
    fin_l, eng_l, _, counts_l = drive_core(api_b, params, core_requests(cfg),
                                           setup=ladder_probe(rec_l), recompress_after=1,
                                           cuda_graphs=True, pipeline_depth=2)
    add({n: counts_l.get(n, 0) for n in ("bcq_linear", "page_gather")})
    eng_l._available_pages = lambda: 0
    for _ in range(LADDER_ROUNDS):
        eng_l._recompress_tick(budget=LADDER_BUDGET)
    del eng_l._available_pages
    eng_l.audit(strict=True)
    rc = eng_l.health()["swap"]["recompressed_pages"]
    if rec_l["pages"] != rc or rc != LADDER_ROUNDS * LADDER_BUDGET:
        fail(f"phase 15: the ladder recompressed {rc} pages, {rec_l['pages']} checked")
    print(f"phase 15 ladder (bf16 pages at full width, recompress_after 1, pressure held for "
          f"{LADDER_ROUNDS} ladder ticks of {LADDER_BUDGET} pages): {rc} parked pages "
          f"recompressed ({rec_l['stages']}), each equal bit for bit to the CPU _fake_quant of "
          f"its bytes fetched before", flush=True)
    return total, {"swaps": time_swap(eng_g, smi), "resume_vs_recompute": resume_vs}


# ------------------------------------------------------------------ phase 16
MOE_ARCH = "moonshot_v1_16b"
MOE_PLAIN_LAYERS = 4  # depth of the whole-run kernel vs plain comparison
# (E, C, K, N) of the stacked fused linear's own checks: decode (C 1), a
# 512-token chunk's wo (C 61), a ragged stack
STACKED_SHAPES = [(64, 1, 2048, 1408), (64, 61, 1408, 2048), (3, 37, 192, 100)]
# launches a layer makes in one forward pass: the stacked B1 for wi, wg and
# wo; the dense B1 for q, k, v and out; B2; the KV-page writer
MOE_PER_LAYER = {"bcq_linear_experts": 3, "bcq_linear": 4, "page_gather": 1, "bcq_page_write": 1}
MOE_COUNTED = tuple(MOE_PER_LAYER)
MOE_MAX_LEN = -(-(max(PROMPT_LENS) + GEN + 1) // 16) * 16  # serve()'s, as phase 4


def stacked_case(e, c, k, n, seed, cb):
    """Seeded expert rows (outlier channels, a zero padding row per expert)
    and an (E, N, K) packed weight stack, each expert with its own s_W."""
    import torch

    from repro_torch.core import bcq, ptq
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((e, c, k), generator=g)
    x[..., :: max(1, k // 8)] *= 12.0
    x[:, -1] = 0.0
    w = (torch.randn((e, k, n), generator=g) * k**-0.5).cuda()
    pk = ptq.decode_scales({"kernel_packed": ptq.pack_stack(w, cb, bcq.BCQConfig())})
    return x.cuda(), ops.packed_operand(pk["kernel_packed"])


def check_stacked(cb):
    """The stacked fused linear at ``STACKED_SHAPES``: bit for bit the E
    per-expert launches of ``bcq_linear``, and within LINEAR_TOL of its plain
    version (``fused_linear_experts_ref``).  Returns the worst max|err|."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_linear as bl
    from repro_torch.kernels.ref import fused_linear_experts_ref

    cfg = bcq.BCQConfig()
    worst = 0.0
    for i, (e, c, k, n) in enumerate(STACKED_SHAPES):
        x, w = stacked_case(e, c, k, n, 160 + i, cb)
        s_x = bcq.tensor_scale(x, cfg)
        args = (w.idx_packed, w.sel_packed, w.inv_scale, cb, s_x, cfg)
        got = bl.bcq_linear_experts(x, *args)
        each = torch.stack([bl.bcq_linear(x[j].contiguous(), w.idx_packed[j], w.sel_packed[j],
                                          w.inv_scale[j], cb, s_x, cfg) for j in range(e)])
        ref = fused_linear_experts_ref(x, w.idx_packed, w.sel_packed, w.inv_scale, cb, cfg, s_x)
        torch.cuda.synchronize()
        ok, err = held(got, ref, LINEAR_TOL, LINEAR_TOL * float(ref.abs().max()))
        same = torch.equal(got, each)
        worst = max(worst, err)
        print(f"phase 16 stacked fused linear E={e} C={c} K={k} N={n}: bit-equal to {e} "
              f"per-expert launches: {same}; vs plain max|err| {err:.3e} (tol rtol={LINEAR_TOL} "
              f"atol={LINEAR_TOL}·max|plain|) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not same:
            fail(f"the stacked fused linear differs from its per-expert launches at E={e} C={c}")
        if not ok:
            fail(f"the stacked fused linear disagrees with its plain version at E={e} C={c}")
    return worst


def hold_launches(eng, n_steps, label="phase 16"):
    """Step ``eng`` ``n_steps`` times with every launch of B1 (stacked and
    dense) and B2 held to its plain version on the inputs it got, and every
    KV-page write captured and held to the plain writer (``hold_writes``).
    Returns (launches held by kernel, worst max|err| by kernel)."""
    from repro_torch.kernels import chunked_prefill, common, ops, paged_attention
    from repro_torch.kernels.ref import fused_linear_experts_ref, fused_linear_ref

    real = {"experts": ops.bcq_linear_experts, "dense": ops.bcq_linear,
            "decode": paged_attention.page_gather_attention,
            "chunk": chunked_prefill.page_gather_attention}
    n = {k: 0 for k in MOE_COUNTED}
    worst = {k: 0.0 for k in MOE_COUNTED}

    def tally(name, ok, err, what):
        if not ok:
            fail(f"{label}: a {name} launch disagrees with its plain version on its own "
                 f"inputs ({what}): max|err| {err:.3e}")
        n[name] += 1
        worst[name] = max(worst[name], err)

    def experts(x, w_idx, w_sel, w_inv, cb, s_x, cfg):
        out = real["experts"](x, w_idx, w_sel, w_inv, cb, s_x, cfg)
        ref = fused_linear_experts_ref(x, w_idx, w_sel, w_inv, cb, cfg, s_x)
        tally("bcq_linear_experts", *held(out, ref, LINEAR_TOL, LINEAR_TOL * float(ref.abs().max())),
              f"E={x.shape[0]} C={x.shape[1]} K={x.shape[2]} N={w_idx.shape[1]}")
        return out

    def dense(x, w_idx, w_sel, w_inv, cb, s_x, cfg):
        out = real["dense"](x, w_idx, w_sel, w_inv, cb, s_x, cfg)
        ref = fused_linear_ref(x, w_idx, w_sel, w_inv, cb, cfg, s_x, valid_k=x.shape[1])
        tally("bcq_linear", *held(out, ref, LINEAR_TOL, LINEAR_TOL * float(ref.abs().max())),
              f"M={x.shape[0]} K={x.shape[1]} N={w_idx.shape[0]}")
        return out

    def gather(key):
        def run(q, pool, bt, kv_len, kind, cfg, cb=None):
            out = real[key](q, pool, bt, kv_len, kind, cfg, cb)
            ref = common.page_gather_attention_plain(q, pool, bt, kv_len, kind, cfg, cb)
            tally("page_gather", *held(out, ref, GATHER_TOL, GATHER_TOL),
                  f"{kind} {tuple(q.shape)} maxp {bt.shape[1]}")
            return out
        return run

    ops.bcq_linear_experts, ops.bcq_linear = experts, dense
    paged_attention.page_gather_attention = gather("decode")
    chunked_prefill.page_gather_attention = gather("chunk")
    calls = []
    try:
        for _ in range(n_steps):
            calls += capture_writes(eng)
    finally:
        ops.bcq_linear_experts, ops.bcq_linear = real["experts"], real["dense"]
        paged_attention.page_gather_attention = real["decode"]
        chunked_prefill.page_gather_attention = real["chunk"]
    n["bcq_page_write"] = len(calls)
    worst["bcq_page_write"] = hold_writes(calls, eng.params["codebooks"], label)
    return n, worst


def moe_launch_checks(api, params, prompts, per_layer=MOE_PER_LAYER, label="phase 16"):
    """Every launch of the first engine step (a prefill chunk of every
    prompt, then a decode tick) and of one steady decode tick (8 rows
    decoding) held to its plain version on its own inputs (``hold_launches``,
    and B3's fake-quant route by ``hold_fake_route`` where ``per_layer``
    counts it; eager depth 1: a wrapper must see each launch).  Returns the
    worst max|err| by kernel and the launches held."""
    from types import SimpleNamespace

    def step():
        return hold_launches(eng, 1, label)

    eng = _fresh_engine(SimpleNamespace(api=api, params=params, max_len=MOE_MAX_LEN), prompts)
    (first, worst1), n_fq1, ties1 = hold_fake_route(step, label)
    first["bcq_quantize"] = n_fq1
    passes = eng.stats["decode_ticks"] + eng.stats["prefill_launches"]
    while eng.queue or any(s.mode == "prefill" for s in eng.slots if s.req is not None):
        eng.step()
    eng.step()
    if sum(s.req is not None and s.mode == "decode" for s in eng.slots) != len(prompts):
        fail(f"{label}: the steady tick of the launch checks has not 8 rows decoding")
    (steady, worst2), n_fq2, ties2 = hold_fake_route(step, label)
    steady["bcq_quantize"] = n_fq2
    layers = api.cfg.n_layers
    for name in set(MOE_COUNTED) | {"bcq_quantize"}:
        per = per_layer.get(name, 0)
        if first[name] != per * layers * passes or steady[name] != per * layers:
            fail(f"{label}: {name}: {first[name]} launches held in the first step "
                 f"({passes} passes), {steady[name]} in the steady tick; expected {per} a layer")
    worst = {k: max(worst1[k], worst2[k]) for k in worst1}
    held_names = [k for k in MOE_COUNTED if per_layer.get(k) and k != "bcq_page_write"]
    print(f"{label} every launch of the first engine step ({passes} passes: a prefill chunk of "
          f"every prompt, a decode tick) and of a steady decode tick (8 rows) vs its plain "
          f"version on its own inputs: launches {first} + {steady}; max|err| "
          f"{ {k: worst[k] for k in held_names} } (B1 rtol={LINEAR_TOL} "
          f"atol={LINEAR_TOL}·max|plain|, B2 atol=rtol={GATHER_TOL}); KV pages equal to the plain "
          f"writer's ({worst['bcq_page_write']} differing idx/sel bytes, codebook ties); B3's "
          f"fake-quant launches decode to the plain encode's values ({ties1 + ties2} with a "
          f"codebook tie)", flush=True)
    return worst, {k: first[k] + steady[k] for k in first}


def moe_counts_ok(counts, way, cfg, what):
    passes = way["out"][1]["decode_ticks"] + way["out"][1]["prefill_launches"]
    expect = {n: per * cfg.n_layers * passes for n, per in MOE_PER_LAYER.items()}
    if any(counts.get(n, 0) != v for n, v in expect.items()):
        fail(f"phase 16 {what}: launches {counts}, expected {expect} ({cfg.n_layers} layers, "
             f"{passes} passes)")
    return expect, passes


def time_stacked(cb, launches, worst_err, smi):
    """The stacked fused linear at the decode shape of moonshot's wi (E 64,
    C 1, K 2048, N 1408) and at a 512-token chunk's wo (C 61, K 1408, N
    2048): event-loop ms, the device time of its two kernels, the plain
    per-expert loop's ms, ``torch.bmm`` in bf16 as the yardstick, and the
    bound (every expert's packed weight bytes at 3.35 TB/s, or the int8
    product)."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_linear as bl
    from repro_torch.kernels.ref import fused_linear_experts_ref

    cfg = bcq.BCQConfig()
    out = []
    for e, c, k, n in ((64, 1, 2048, 1408), (64, 61, 1408, 2048)):
        x, w = stacked_case(e, c, k, n, 170 + c, cb)
        s_x = bcq.tensor_scale(x, cfg)
        args = (w.idx_packed, w.sel_packed, w.inv_scale, cb, s_x, cfg)
        ms = cuda_ms(lambda: bl.bcq_linear_experts(x, *args), iters=50)
        plain_ms = cuda_ms(lambda: fused_linear_experts_ref(
            x, w.idx_packed, w.sel_packed, w.inv_scale, cb, cfg, s_x), iters=3, warmup=1)
        xb = x.to(torch.bfloat16)
        wb = torch.randn((e, k, n), device="cuda").to(torch.bfloat16)
        library_ms = cuda_ms(lambda: torch.bmm(xb, wb))
        m = e * c
        nbytes = (m * k * 4 + e * (n * k // 2 + n * k // 16 + n * k // 64 * 4) + 8 * 16 * 4 + 4
                  + m * n * 4)
        bound, by = _bound(nbytes, (2 * m * n * k, INT8_OPS), (ENCODE_OPS * m * k, F32_FLOPS))
        split = _linear_split(kernel_split_ms(lambda: bl.bcq_linear_experts(x, *args), bound,
                                              f"bcq_linear_experts at E={e} C={c}"))
        print(f"phase 16 stacked fused linear timing at E={e} C={c} K={k} N={n}: kernel "
              f"{ms:.4f} ms (device {split['device_ms']:.4f} ms: encode pass "
              f"{split['encode_ms'] or 0:.4f}, GEMM {split['gemm_ms'] or 0:.4f}, torch.profiler), "
              f"bound {bound:.5f} ms by {by} ({nbytes} B at {HBM_BPS:.3g} B/s), device/bound "
              f"{split['device_ms'] / bound:.2f}; plain (per-expert fused_linear_ref) "
              f"{plain_ms:.3f} ms; torch.bmm bf16 {library_ms:.4f} ms; {smi}", flush=True)
        out.append({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "library_ms": library_ms, **split, "shape": f"E {e} C {c} K {k} N {n}"})
    dec, chunk = out
    return {"name": "bcq_linear_experts", "route": "cuda",
            "source": "src/repro_torch/csrc/bcq_linear.cu",
            "replaces": "src/repro/kernels/bcq_linear.py:81", "launches": launches,
            "launches_by_path": {"moe": launches}, "max_abs_err": worst_err, **dec,
            "bound_peak": W4A4_PEAKS, "at_chunk": chunk}


def phase_moe(cb, smi):
    """Phase 16: full-width, full-depth Moonlight-16B-A3B (``moonshot_v1_16b``:
    48 layers, d 2048, 16 heads of 128, 64 experts top-6, d_ff_expert 1408,
    vocab 163840; seeded random weights drawn and packed to W4 a layer at a
    time on the card) served in W4A4 from bcq4 pages through the kernels,
    phase 4's settings and requests: the production tick (graph depth 2)
    and eager depth 1 equal bit for bit (tokens, margins, launch indices,
    counters, pool bytes, launch counts), exact launch counts (the stacked
    B1 3 × 48 a pass, the dense B1 4 × 48, B2 and the writer 48), every
    launch of the first engine step and of a steady decode tick held to its
    plain version; then kernels (graph depth 2) and plain paths (eager depth
    1) at 4 layers of the same width agree under the margin rule, and every
    launch of phase 11's workload at 4 layers is held to the plain paths
    (``check_shadow``).  Returns
    (the phase's launches by kernel, the stacked form's ``kernels`` entry,
    the worst launch errors)."""
    import dataclasses
    from types import SimpleNamespace

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_model, serve
    from repro_torch.serving.generate import greedy_agreement

    t_phase = time.perf_counter()
    cfg = get_arch(MOE_ARCH)
    err_stacked = check_stacked(cb)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api, params = build_model(cfg, "bcq4", True, "cuda", 0, True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"phase 16 {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_ff_expert "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}: drawn and packed a layer at a time on the "
          f"card in {init_s:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
    model = SimpleNamespace(api=api, params=params, max_len=MOE_MAX_LEN)
    ways = [(_way_name(g, d), production_way(model, prompts, g, d, n, label="phase 16"))
            for g, d, n in ((True, 2, 10), (False, 1, 3))]
    _hold_ways(ways, f"{cfg.name}, phase 4's workload", "phase 16")
    g2 = ways[0][1]
    total = {n: g2["counts"].get(n, 0) for n in MOE_COUNTED}
    expect, passes = moe_counts_ok(g2["counts"], g2, cfg, "graph depth 2")
    st = g2["engine"].stats
    prof = g2["prof"]
    busy = "not measured" if prof is None else f"{prof[1]:.3f} ms"
    print(f"phase 16 {cfg.name}: graph depth 2 ≡ eager depth 1 bit for bit (tokens, margins, "
          f"launch indices, counters, pool bytes, launch counts); launches {expect} over {passes} "
          f"passes; steady tick (8 rows): wall {g2['wall']:.2f} ms/tick at graph depth 2 "
          f"(device {busy}), {ways[1][1]['wall']:.2f} ms eager depth 1; decode graph nodes "
          f"{g2['nodes']}; prefill {st['prefill_tokens'] / max(st['t_prefill_s'], 1e-9):.0f} "
          f"tok/s; {smi}", flush=True)
    for _, w in ways:
        w.pop("engine")
    del ways
    profile_decode(model, prompts, f"{cfg.name}, kernels, eager depth 1", cb)  # by kernel
    worst, _ = moe_launch_checks(api, params, prompts)
    entry = time_stacked(cb, total["bcq_linear_experts"],
                         max(err_stacked, worst["bcq_linear_experts"]), smi)
    del api, params, model
    torch.cuda.empty_cache()

    # whole runs at 4 layers of the same width: kernels vs plain paths
    cfg4 = dataclasses.replace(cfg, n_layers=MOE_PLAIN_LAYERS)
    runs = {}
    for kernels in (True, False):
        mode = {} if kernels else {"pipeline_depth": 1, "cuda_graphs": False}
        build.reset_counts()
        fin, eng = serve(cfg4, prompts, GEN, cache="bcq4", packed=True, page_size=16,
                         prefill_chunk=64, device="cuda", seed=0, kernels=kernels,
                         chunked_prefill=True, prefix_caching=False, **mode)
        torch.cuda.synchronize()
        runs[kernels] = (fin, eng, build.counts())
    (fin_k, eng_k, c_k), (fin_p, eng_p, c_p) = runs[True], runs[False]
    if any(c_p.get(n) for n in MOE_COUNTED):
        fail(f"phase 16: kernels launched in the plain run: {c_p}")
    moe_counts_ok(c_k, {"out": _outcome(eng_k)}, cfg4, f"{MOE_PLAIN_LAYERS} layers")
    for n in MOE_COUNTED:
        total[n] += c_k.get(n, 0)
    tol = phase_logits(eng_k, eng_p, prompts,
                       [r.out[0] for r in sorted(fin_p, key=lambda r: r.rid)])
    agree = greedy_agreement({r.rid: r for r in fin_p}, {r.rid: r for r in fin_k}, tol)
    print(f"phase 16 {cfg.name} at {MOE_PLAIN_LAYERS} layers: greedy tokens kernels (graph depth "
          f"2) vs plain (eager depth 1) under the margin rule (logit tol {tol:.3e}, the noise "
          f"floor): {agree}", flush=True)
    if not agree["ok"]:
        fail("phase 16: the kernel and plain runs disagree beyond the margin rule")
    # the whole-run comparison stops at the first launch whose tokens part;
    # phase 11's workload at 4 layers holds every launch to the plain paths
    api_k4, api_p4, params4 = eng_k.api, eng_p.api, eng_k.params
    del runs, fin_k, eng_k, fin_p, eng_p
    fin_c, eng_c, _, c_c = drive_core(api_k4, params4, core_requests(cfg4), cuda_graphs=True,
                                      pipeline_depth=2)
    moe_counts_ok(c_c, {"out": _outcome(eng_c)}, cfg4, f"{MOE_PLAIN_LAYERS} layers, phase 11's "
                  "workload")
    for n in MOE_COUNTED:
        total[n] += c_c.get(n, 0)
    check_shadow(api_k4, api_p4, params4, core_requests(cfg4), fin_c, tol,
                 f"workload on {cfg.name} at {MOE_PLAIN_LAYERS} layers, graph depth 2",
                 ("sampled", "resumed", "fork", "cow"), cuda_graphs=True, pipeline_depth=2)
    del fin_c, eng_c, api_k4, api_p4, params4
    entry["launches"] = entry["launches_by_path"]["moe"] = total["bcq_linear_experts"]
    torch.cuda.empty_cache()
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total, entry, worst


# ------------------------------------------------------------------ phase 17
PTQ_DIR = os.path.join(ROOT, "build", "ptq")  # under the ignored build/
PTQ_FORMATS = ("bcq", "mx4", "mxfp4", "vsq", "int4", "none")  # Runtime.act_format
# launches a layer makes in one forward pass of each served artifact: the
# fake one encodes 4 activations a layer through B3 (qkv once, out, mlp
# in, mlp out); the packed one runs 6 fused linears
PTQ_PER_LAYER = {"fake": {"bcq_quantize": 4, "page_gather": 1, "bcq_page_write": 1},
                 "packed": {"bcq_linear": 6, "page_gather": 1, "bcq_page_write": 1}}
PTQ_FIT_RTOL = 2e-4  # the card's fit history vs the CPU fit's (f32 sums in another order)


def hold_fake_route(run, label):
    """Run ``run()`` with every launch of B3 (``bcq_quantize``: the fake-quant
    route of ``bcq.fake_quant``) held to ``quantize_ref`` on the launch's own
    inputs: ratios equal, and the values the route decodes,
    C_sel[idx] / (ratio · s_X), equal bit for bit (idx / sel bytes may
    differ on a codebook tie).  Returns (what ``run`` returned, launches
    held, launches with a tie)."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_quantize as bq
    from repro_torch.kernels.ref import quantize_ref

    real = bq.bcq_quantize
    n = [0, 0]

    def check(x, cb, s_x, cfg):
        idx, sel, ratio = real(x, cb, s_x, cfg)
        r_idx, r_sel, r_ratio = quantize_ref(x, cb, cfg, s_x)
        if not torch.equal(ratio, r_ratio):
            fail(f"{label}: a B3 fake-quant launch's ratios differ from the plain encode's "
                 f"(M={x.shape[0]} K={x.shape[1]})")
        if not (torch.equal(idx, r_idx) and torch.equal(sel, r_sel)):
            scale = r_ratio * s_x
            if not torch.equal(bcq.dequantize(idx, sel, scale, cb, cfg),
                               bcq.dequantize(r_idx, r_sel, scale, cb, cfg)):
                fail(f"{label}: a B3 fake-quant launch decodes to other values than the plain "
                     f"encode (M={x.shape[0]} K={x.shape[1]})")
            n[1] += 1
        n[0] += 1
        return idx, sel, ratio

    bq.bcq_quantize = check
    try:
        out = run()
    finally:
        bq.bcq_quantize = real
    return out, n[0], n[1]


def _counted(fn, totals):
    """``fn()`` on counts set to 0 just before; its launches added to
    ``totals``.  Returns (what ``fn`` returned, its launches by kernel)."""
    import torch

    from repro_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = build.counts()
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return out, counts


def _expect(counts, want, what):
    got = {k: counts.get(k, 0) for k in want}
    if got != want or any(v for k, v in counts.items() if k not in want):
        fail(f"phase 17 {what}: launches {counts}, expected {want} and no other")


def ptq_fit_checks(params, cfg, calib, written):
    """The fit on the card twice (15 LO-BCQ iterations, the quantize CLI's)
    on the CLI's samples: byte-equal to each other and to the codebooks the
    CLI wrote, the history non-increasing, and the codebooks equal to the
    port's CPU fit of the same samples.  Returns (card fit s, CPU fit s)."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.core.calibrate import capture_gemm_inputs, stacked_kernels
    from repro_torch.models.layers import Runtime

    rt = Runtime(quant_mode="none", compute_dtype=torch.float32)
    samples = capture_gemm_inputs(params, calib, cfg, rt)
    samples += [leaf.reshape(-1)[: 1 << 16] for leaf in stacked_kernels(params["layers"])]
    n_blocks = sum(s.numel() // 64 * 8 for s in samples)
    fits, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits.append(bcq.fit_lobcq(samples, bcq.BCQConfig(), iters=15))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    a, b = fits
    if a.levels.tobytes() != b.levels.tobytes() or a.history != b.history:
        fail("phase 17: two LO-BCQ fits on the card differ")
    if a.levels.tobytes() != written.levels.tobytes():
        fail("phase 17: the quantize CLI's codebooks differ from a fit of its own samples")
    h = a.history
    if not all(y <= x for x, y in zip(h, h[1:])):
        fail(f"phase 17: the fit's MSE history increases: {h}")
    t0 = time.perf_counter()
    cpu = bcq.fit_lobcq([s.cpu() for s in samples], bcq.BCQConfig(), iters=15)
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(cpu.levels, a.levels):
        fail(f"phase 17: the card's fit and the CPU fit give other codebooks:\n{a.levels}\n"
             f"{cpu.levels}")
    rel = max(abs(x - y) / y for x, y in zip(h, cpu.history)) if len(h) == len(cpu.history) else 1
    if not rel <= PTQ_FIT_RTOL:
        fail(f"phase 17: the fit histories of the card and the CPU part by {rel:.2e} "
             f"(tol {PTQ_FIT_RTOL}): {h} vs {cpu.history}")
    print(f"phase 17 LO-BCQ fit on the card ({len(samples)} samples, {n_blocks} blocks of 8, "
          f"{len(h)} iterations of 25 Lloyd-Max passes): {secs[0]:.2f} s, again {secs[1]:.2f} s, "
          f"byte-equal to each other and to the CLI's codebooks; MSE history {h[0]:.6f} → "
          f"{h[-1]:.6f}, non-increasing; the port's CPU fit of the same samples ({cpu_s:.1f} s): "
          f"codebooks equal, history within {rel:.1e}", flush=True)
    return secs[0], cpu_s


def ptq_eval(cfg, floats, fake, packed, batches, totals):
    """Held-out loss over phase 9's batches (bf16, the flash kernel) of the
    fake artifact under every act_format, of the float weights quantized in
    the forward (``fake_full``), and of the packed artifact; launch counts
    per forward; every B3 launch of one fake and one fake_full forward, and
    every B1 and B5 launch of one packed forward, held to its plain
    version (``fake_full`` quantizes the float weights, ``floats``, in the
    forward).  Returns (losses by name, the worst B1 / B5 errors)."""
    import dataclasses
    import math

    import torch

    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    L, nb = cfg.n_layers, len(batches)
    base = Runtime(compute_dtype=torch.bfloat16, flash_kernel=True)
    runs = [(f"fake {f}", dataclasses.replace(base, quant_mode="fake", act_format=f), fake,
             {"bcq_quantize": 4 * L * nb if f == "bcq" else 0, "flash_attention": L * nb})
            for f in PTQ_FORMATS]
    runs += [("fake_full bcq", dataclasses.replace(base, quant_mode="fake_full"), floats,
              {"bcq_quantize": 10 * L * nb, "flash_attention": L * nb}),
             ("packed", dataclasses.replace(base, quant_mode="packed"), packed,
              {"bcq_linear": 6 * L * nb, "flash_attention": L * nb})]
    losses, err = {}, {}
    for name, rt, params, want in runs:
        api = zoo.build(cfg, rt, device="cuda")
        t0 = time.perf_counter()
        (ls, ms), counts = _counted(lambda: _eval_losses(api, params, batches), totals)
        _expect(counts, {k: v for k, v in want.items() if v}, f"evaluation [{name}]")
        mean = sum(ls) / nb
        if not math.isfinite(mean):
            fail(f"phase 17: non-finite held-out loss [{name}]: {ls}")
        losses[name] = mean
        print(f"phase 17 eval [{name:13s}]: loss {mean:.6f} (per batch "
              f"{', '.join(f'{x:.6f}' for x in ls)}), {ms[-1]:.1f} ms/forward of "
              f"{EVAL_BATCH} × {EVAL_SEQ} tokens ({time.perf_counter() - t0:.1f} s)", flush=True)
        if name in ("fake bcq", "fake_full bcq"):
            _, n, ties = hold_fake_route(lambda: api.loss_fn(params, batches[0]),
                                         f"phase 17 eval [{name}]")
            if n != want["bcq_quantize"] // nb:
                fail(f"phase 17 eval [{name}]: {n} B3 launches held in one forward")
            print(f"phase 17 eval [{name}]: every B3 launch of one forward ({n}) decodes to the "
                  f"plain encode's values ({ties} with a codebook tie)", flush=True)
        if name == "packed":
            err = check_eval_launches(api, params, batches[0])
    return losses, err


def ptq_serve(artifact, cfg, params, prompts, totals, smi):
    """One artifact served on phase 4's settings and prompts: the
    production tick (graph depth 2) and eager depth 1 equal bit for bit,
    launch counts per pass, and every launch of a prefill and a steady
    tick held to its plain version.  Returns (the graph depth 2 way, the
    worst launch errors)."""
    from types import SimpleNamespace

    import torch

    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    rt = Runtime(quant_mode=artifact, compute_dtype=torch.float32, cache_kind="bcq4",
                 paged_kernel=True)
    api = zoo.build(cfg, rt, device="cuda")
    model = SimpleNamespace(api=api, params=params, max_len=MOE_MAX_LEN)
    ways = [(_way_name(g, d), production_way(model, prompts, g, d, n, label="phase 17"))
            for g, d, n in ((True, 2, 10), (False, 1, 3))]
    _hold_ways(ways, f"{artifact} artifact, phase 4's workload", "phase 17")
    g2 = ways[0][1]
    passes = g2["out"][1]["decode_ticks"] + g2["out"][1]["prefill_launches"]
    want = {k: v * cfg.n_layers * passes for k, v in PTQ_PER_LAYER[artifact].items()}
    _expect(g2["counts"], want, f"{artifact} artifact served at graph depth 2")
    for k, v in g2["counts"].items():
        totals[k] = totals.get(k, 0) + v
    worst, _ = moe_launch_checks(api, params, prompts, PTQ_PER_LAYER[artifact],
                                 f"phase 17 [{artifact} artifact]")
    prof = g2["prof"]
    busy = "not measured" if prof is None else f"{prof[1]:.3f} ms"
    print(f"phase 17 [{artifact} artifact]: graph depth 2 ≡ eager depth 1 bit for bit; launches "
          f"{want} over {passes} passes; steady tick (8 rows): wall {g2['wall']:.2f} ms at graph "
          f"depth 2 (device {busy}, {sum(g2['nodes'].values())} graph nodes over "
          f"{len(g2['nodes'])} widths), {ways[1][1]['wall']:.2f} ms eager depth 1; {smi}",
          flush=True)
    for _, w in ways:
        w.pop("engine")
    return g2, worst


def time_fake_route(cb):
    """B3's fake-quant form: ``bcq.fake_quant`` of a CUDA tensor at decode
    (M 8) and at the evaluation's (M 8192), K 768 — event-loop ms of the
    whole route, B3's device time in it (the mean of the profiler events it
    got), the plain ``fake_quant_plain``, and B3's bound at that shape."""
    from repro_torch.core import bcq

    cfg = bcq.BCQConfig()
    out = {}
    for m, k, seed in ((8, 768, 81), (EVAL_SEQ * EVAL_BATCH, 768, 82)):
        x = activation(m, k, seed)
        ms = cuda_ms(lambda: bcq.fake_quant(x, cb, cfg))
        plain_ms = cuda_ms(lambda: bcq.fake_quant_plain(x, cb, cfg), iters=5)
        nbytes = m * k * 4 + m * k // 2 + m * k // 16 + m * k // 64 * 4 + 8 * 16 * 4 + 4
        bound, by = _bound(nbytes, (ENCODE_OPS * m * k, F32_FLOPS))
        iters, dev = 20, None
        for _ in range(3):
            got = _device_kernels(lambda: bcq.fake_quant(x, cb, cfg), iters)
            if got is None:
                continue
            n_kern, route_dev, by_name, seen = got
            enc = [nm for nm in by_name if "encode_kernel" in nm]
            if len(enc) == 1 and seen[enc[0]] >= iters / 2:
                dev = by_name[enc[0]] * iters / seen[enc[0]]
                if dev >= bound:
                    break
        if dev is None:
            fail(f"phase 17: torch.profiler lost B3's fake-quant launches at M={m} K={k}")
        out[m] = {"shape": f"M {m} K {k}", "ms": ms, "device_ms": dev,
                  "route_device_ms": route_dev, "route_kernels": n_kern, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": None}
        print(f"B3 fake-quant form (bcq.fake_quant) at M={m} K={k}: {ms:.4f} ms a call (event "
              f"loop), B3's encode {dev:.4f} ms device, the route's {n_kern:.0f} kernels "
              f"{route_dev:.4f} ms device (torch.profiler), plain fake_quant_plain "
              f"{plain_ms:.4f} ms, B3 bound {bound:.5f} ms by {by}", flush=True)
    return {**out[8], "at_eval": out[EVAL_SEQ * EVAL_BATCH]}


def phase_ptq(cb, smi):
    """Phase 17: the PTQ deploy step on full-width gpt3_126m.  Seeded float
    weights on the card saved by the port's ``CheckpointManager`` and
    restored (bytes equal); ``python -m repro_torch.launch.quantize``'s
    ``main`` on the card (calibration: one batch of 4 × 128 tokens, 15
    LO-BCQ iterations; the fake and packed artifacts, the manifest); the
    fit twice byte-equal, non-increasing, equal to the port's CPU fit; the
    held-out loss of the fake artifact under every act_format, of
    ``fake_full`` and of the packed artifact; both artifacts served at graph
    depth 2 ≡ eager depth 1 with every launch of a prefill and a steady
    tick held to plain.  Returns (the phase's launches by kernel, the worst
    B1 / B2 / B5 errors, B3's fake-quant form)."""
    import shutil

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager, load_pytree
    from repro_torch.configs.base import get_arch
    from repro_torch.core import ptq
    from repro_torch.core.bcq import BCQConfig, CodebookSet
    from repro_torch.data.pipeline import DataConfig, batch_at, eval_stream
    from repro_torch.launch import quantize
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    t_phase = time.perf_counter()
    cfg = get_arch("gpt3_126m")
    shutil.rmtree(PTQ_DIR, ignore_errors=True)
    ck, out = os.path.join(PTQ_DIR, "ckpt"), os.path.join(PTQ_DIR, "w4")
    params = zoo.build(cfg, Runtime(compute_dtype=torch.float32), device="cuda").init(0)
    t0 = time.perf_counter()
    mgr = CheckpointManager(ck, keep=2)
    mgr.save(1, {"params": params})  # the async writer
    mgr.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, state = mgr.restore()
    restore_s = time.perf_counter() - t0
    flat = lambda t, p="": ([x for k in sorted(t) for x in flat(t[k], f"{p}/{k}")]  # noqa: E731
                            if isinstance(t, dict) else [(p, t)])
    mine, back = flat(params), flat(state["params"])
    if step != 1 or [p for p, _ in mine] != [p for p, _ in back] or not all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b) for (_, a), (_, b) in zip(mine, back)):
        fail("phase 17: the restored checkpoint differs from the saved weights")
    ck_bytes = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
    print(f"phase 17 checkpoint: {len(mine)} leaves, {ck_bytes} B on disk, saved (async writer) "
          f"in {save_s:.2f} s, restored in {restore_s:.2f} s, every leaf equal bit for bit",
          flush=True)

    totals = {}
    t0 = time.perf_counter()
    manifest, counts = _counted(lambda: quantize.main(["--ckpt", ck, "--out", out]), totals)
    quant_s = time.perf_counter() - t0
    _expect(counts, {"bcq_quantize": 6}, "quantize CLI")  # quantize_params: 6 layer stacks
    stats = ptq.count_quantized_bits(params, BCQConfig())
    sizes = {n: os.path.getsize(os.path.join(out, n)) for n in sorted(os.listdir(out))}
    packed_bytes = sum(int(np.prod(s)) for s in manifest["packed_tensors"].values()) * (
        1 + 1 / 8 + 1 / 32)  # idx K/2, sel K/16, scale K/64 bytes a row (the shapes: idx)
    print(f"phase 17 quantize CLI on the card: {quant_s:.2f} s; artifacts {sizes} B; GEMM "
          f"weights {stats['gemm_params']} of {stats['params']} params at {manifest['bcq']['bits']} "
          f"bits (Eq. 9), the packed buffers {packed_bytes:.0f} B = "
          f"{packed_bytes * 8 / stats['gemm_params']:.4f} bits a weight (selectors stored as "
          f"nibbles); compression vs bf16 {manifest['compression_vs_bf16']:.4f}", flush=True)
    written = CodebookSet.load(os.path.join(out, "codebooks.json"))
    calib = batch_at(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=4), quantize.CALIB_STEP,
                     device="cuda")["tokens"]
    fit_s, cpu_fit_s = ptq_fit_checks(params, cfg, calib, written)
    cb_fit = written.as_tensor("cuda")
    _, n_w, ties_w = hold_fake_route(lambda: ptq.quantize_params(params, cb_fit, BCQConfig()),
                                     "phase 17 quantize_params")
    print(f"phase 17 quantize_params: every B3 launch ({n_w}) decodes to the plain encode's "
          f"values ({ties_w} with a codebook tie)", flush=True)
    del state, mine, back

    to_cuda = lambda t: ({k: to_cuda(v) for k, v in t.items()} if isinstance(t, dict)  # noqa: E731
                         else t.to("cuda"))
    fake = to_cuda(load_pytree(os.path.join(out, "weights_w4_fake.npz")))
    packed = ptq.packed_from_artifact(
        fake, to_cuda(load_pytree(os.path.join(out, "weights_w4_packed.npz"))))
    dc = DataConfig(vocab=cfg.vocab, seq_len=EVAL_SEQ, global_batch=EVAL_BATCH)
    batches = list(eval_stream(dc, EVAL_BATCHES, device="cuda"))
    losses, err_ev = ptq_eval(cfg, dict(params, codebooks=fake["codebooks"]), fake, packed,
                              batches, totals)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    served, worst = {}, {}
    for artifact, params_a in (("fake", fake), ("packed", packed)):
        served[artifact], w = ptq_serve(artifact, cfg, params_a, prompts, totals, smi)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in w.items()}
    fake_form = time_fake_route(cb)
    print(f"phase 17 summary: fit {fit_s:.2f} s on the card ({cpu_fit_s:.1f} s on the CPU), "
          f"quantize CLI {quant_s:.2f} s; held-out losses "
          f"{ {k: round(v, 6) for k, v in losses.items()} }; steady decode tick at graph depth "
          f"2: fake {served['fake']['wall']:.2f} ms, packed {served['packed']['wall']:.2f} ms; "
          f"launches {totals}; phase 17 {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    worst["bcq_linear"] = max(worst["bcq_linear"], err_ev.get("bcq_linear", 0.0))
    worst["flash_attention"] = err_ev.get("flash_attention", 0.0)
    return totals, worst, fake_form


# ------------------------------------------------------------------ phase 10
def _bound(nbytes, *work):
    """The least time (ms) for ``nbytes`` of HBM traffic and the ``(ops,
    peak per second)`` pairs of ``work`` (each on its own units, which run
    side by side), and which of bytes and operations bounds it."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max(ops / peak * 1e3 for ops, peak in work)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


ENCODE_OPS = 8 * (1 + 3)  # per scalar and codebook: a table read, d, d², Σ


def kernel_split_ms(fn, bound, what, iters=10, tries=3):
    """Device ms per call of each CUDA kernel ``fn`` launches (each once a
    call), by name: the mean of its events in a torch.profiler window of
    ``iters`` calls after a warm-up.  In this script the profiler drops
    a few events of a window, so a kernel is timed by the events the
    profiler saw; a window that saw no kernel, fewer than half the calls
    of one, or a device time below ``bound`` (ms, the least time the work
    can take) is profiled again, up to ``tries`` times; then the run
    fails."""
    import torch

    fn()
    torch.cuda.synchronize()
    seen = None
    for _ in range(tries):
        got = _device_kernels(fn, iters)
        if got is None:
            continue
        _, _, by_name, seen = got
        if max(seen.values()) > iters:
            fail(f"{what} launched a kernel more than once a call: {seen}")
        ms = {nm: by_name[nm] * iters / c for nm, c in seen.items()}
        if sum(ms.values()) >= bound and min(seen.values()) >= iters / 2:
            lost = sum(iters - c for c in seen.values())
            if lost:
                print(f"  ({what}: the profiler lost {lost} of {iters * len(seen)} kernel "
                      f"events; each kernel timed by the mean of those it saw)", flush=True)
            return ms
        print(f"  ({what}: a profiler window read {seen} events, {sum(ms.values()):.5f} ms "
              f"against the bound {bound:.5f}; profiled again)", flush=True)
    fail(f"torch.profiler dropped kernels of {what} in {tries} windows of {iters} calls "
         f"(last window's events by kernel: {seen}; bound {bound:.5f} ms)")


def device_ms(by_name):
    """Device ms per call summed over a call's kernels.  Where a call's
    device work is a few microseconds, back-to-back calls are paced by the
    host, and ``cuda_ms`` measures that pace instead."""
    return sum(by_name.values())


def _linear_split(by_name):
    """B1's two device kernels: encode pass and GEMM, ms per call."""
    pick = lambda key: sum(ms for nm, ms in by_name.items() if key in nm) or None  # noqa: E731
    return {"encode_ms": pick("encode_kernel"), "gemm_ms": pick("gemm_"),
            "device_ms": device_ms(by_name)}


def _linear_times(cb, m, k, n, seed):
    """Fused linear at (m, k, n): kernel, plain and bf16 torch.matmul ms,
    bound, and the kernel's two device kernels split out."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_linear as bl
    from repro_torch.kernels.ref import fused_linear_ref

    cfg = bcq.BCQConfig()
    x, w = linear_case(m, k, n, seed, cb)
    s_x = bcq.tensor_scale(x, cfg)
    args = (x, w.idx_packed, w.sel_packed, w.inv_scale, cb)
    ms = cuda_ms(lambda: bl.bcq_linear(*args, s_x, cfg), iters=50 if m < 1024 else 10)
    plain_ms = cuda_ms(lambda: fused_linear_ref(*args, cfg, s_x, valid_k=k), iters=10)
    ref = fused_linear_ref(*args, cfg, s_x, valid_k=k)
    ok, err = held(bl.bcq_linear(*args, s_x, cfg), ref, LINEAR_TOL, LINEAR_TOL * float(ref.abs().max()))
    if not ok:
        fail(f"fused linear disagrees with its plain version at M={m} K={k} N={n}: {err:.3e}")
    xb = x.to(torch.bfloat16)
    wb = torch.randn((k, n)).cuda().to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.matmul(xb, wb))
    nbytes = m * k * 4 + n * k // 2 + n * k // 16 + n * k // 64 * 4 + 8 * 16 * 4 + 4 + m * n * 4
    enc = ENCODE_OPS * m * k  # encode x once
    bound, by = _bound(nbytes, (2 * m * n * k, INT8_OPS), (enc, F32_FLOPS))
    split = _linear_split(kernel_split_ms(lambda: bl.bcq_linear(*args, s_x, cfg), bound,
                                          f"bcq_linear at M={m} K={k} N={n}"))
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    print(f"bcq_linear timing at M={m} K={k} N={n}: kernel {ms:.4f} ms (encode pass "
          f"{fmt(split['encode_ms'])}, GEMM {fmt(split['gemm_ms'])}, torch.profiler), plain "
          f"{plain_ms:.4f} ms, torch.matmul bf16 {library_ms:.4f} ms, bound {bound:.5f} ms by {by} "
          f"({nbytes} B, {2 * m * n * k} product OP at {INT8_OPS:.3g}/s, {enc} encode OP at "
          f"{F32_FLOPS:.3g}/s; {2 * m * n * k / F32_FLOPS * 1e3:.5f} ms if the product ran at "
          f"the f32 peak); kernel vs plain max|err| {err:.3e}; earlier run: "
          f"{EARLIER_MS['bcq_linear'].get((m, k, n), 'not measured')} ms", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, **split}


def time_linear(cb, worst_err, launches):
    m_ev = EVAL_SEQ * EVAL_BATCH
    dec = _linear_times(cb, 8, 768, 3072, 99)  # decode mlp-in: n_slots rows
    ev = _linear_times(cb, m_ev, 768, 3072, 98)  # evaluation mlp-in
    ev_out = _linear_times(cb, m_ev, 3072, 768, 97)  # evaluation mlp-out
    return {
        "name": "bcq_linear", "route": "cuda", "source": "src/repro_torch/csrc/bcq_linear.cu",
        "replaces": "src/repro/kernels/bcq_linear.py:81", "launches": sum(launches.values()),
        "launches_by_path": launches, "max_abs_err": worst_err, **dec,
        "bound_peak": W4A4_PEAKS, "shape": "M 8 K 768 N 3072 (decode)",
        "at_eval": dict(ev, shape=f"M {m_ev} K 768 N 3072"),
        "at_eval_mlp_out": dict(ev_out, shape=f"M {m_ev} K 3072 N 768"),
    }


def _gather_times(cb, c, kv_len, seed):
    """Page gather (bcq4, page 16, 12 heads of 64) over rows of ``kv_len``
    tokens with ``c`` queries each: kernel (event loop and device time of
    its two launches), plain, bound."""
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.kernels import common

    cfg = BCQConfig()
    ps, hkv, d = 16, 12, 64
    b = len(kv_len)
    maxp = -(-max(kv_len) // ps)
    n_pages = 1 + b * maxp
    pool = gather_pool("bcq4", n_pages, ps, hkv, d, seed, cb)
    bt, kvl = gather_case(b, maxp, ps, kv_len, seed + 1, n_pages)
    q = torch.randn((b, c, hkv, d), generator=torch.Generator().manual_seed(seed + 2)).cuda()
    run = (q, pool, bt, kvl, "bcq4", cfg, cb)
    ms = cuda_ms(lambda: common.page_gather_attention(*run))
    plain_ms = cuda_ms(lambda: common.page_gather_attention_plain(*run), iters=10)
    ok, err = held(common.page_gather_attention(*run), common.page_gather_attention_plain(*run),
                   GATHER_TOL, GATHER_TOL)
    if not ok:
        fail(f"page_gather disagrees with its plain version at C={c} kv_len={kv_len}: {err:.3e}")
    pages = sum(max(1, -(-n // ps)) for n in kv_len)
    page_bytes = ps * hkv * (d // 2 + d // 16 + d // 64)  # one K or V page
    nbytes = q.numel() * 4 * 2 + 2 * pages * page_bytes + bt.numel() * 4 + b * 4 + 8 * 16 * 4 + 8
    seen = sum(n - c + i + 1 for n in kv_len for i in range(c))  # (query, key) pairs, causal
    flops = 4 * hkv * d * seen  # QK and PV, H = Hkv
    bound, by = _bound(nbytes, (flops, F32_FLOPS))
    by_name = kernel_split_ms(lambda: common.page_gather_attention(*run), bound,
                              f"page_gather at C={c}")
    pick = lambda key: sum(t for nm, t in by_name.items() if key in nm)  # noqa: E731
    return {"ms": ms, "device_ms": device_ms(by_name), "split_ms": pick("split_kernel"),
            "combine_ms": pick("combine_kernel"), "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "nbytes": nbytes, "flops": flops, "err": err}


def time_gather(cb, worst_err, launches):
    kv_dec = [n + GEN for n in PROMPT_LENS]  # decode at the end of the serving run
    dec = _gather_times(cb, 1, kv_dec, 5)
    kv_pre = [500] * 8  # a full prefill chunk of 8 rows at the longest prompt
    pre = _gather_times(cb, 64, kv_pre, 15)
    for nm, t, shape in (("decode", dec, f"B=8 C=1 kv_len={kv_dec}"),
                         ("chunked prefill", pre, "B=8 C=64 kv_len=500")):
        dev = f"{t['device_ms']:.4f} ms = split {t['split_ms']:.4f} + combine {t['combine_ms']:.4f}"
        print(f"page_gather timing at {nm} {shape} H=12 D=64 bcq4: kernel {t['ms']:.4f} ms "
              f"(device {dev}, torch.profiler), plain {t['plain_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({t['nbytes']} B, "
              f"{t['flops']} f32 FLOP); kernel vs plain max|err| {t['err']:.3e}"
              + (f"; earlier run: {EARLIER_MS['page_gather']} ms" if nm == "decode" else ""), flush=True)
    strip = lambda t: {k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}  # noqa: E731
    return {
        "name": "page_gather", "route": "cuda", "source": "src/repro_torch/csrc/page_gather.cu",
        "replaces": "src/repro/kernels/common.py:265", "launches": sum(launches.values()),
        "launches_by_path": launches, "max_abs_err": worst_err, **strip(dec), "library_ms": None,
        "bound_peak": "f32 67 TFLOP/s", "shape": "B 8 C 1 H 12 D 64 bcq4 kv 80-532 (decode)",
        "at_prefill": dict(strip(pre), shape="B 8 C 64 H 12 D 64 bcq4 kv 500"),
    }


def time_flash(worst_err, launches):
    """Flash at the evaluation shape: (4 · 12, 2048, 64) bf16, causal."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    bh, s_len, d = EVAL_BATCH * 12, EVAL_SEQ, 64
    q, k, v = (torch.randn((bh, s_len, d), device="cuda").to(torch.bfloat16) for _ in range(3))
    ms = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v, True), iters=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True), iters=5)
    q32, k32, v32 = (t.float() for t in (q, k, v))  # the f32 specialisation (CUDA cores)
    f32_ms = cuda_ms(lambda: fa.flash_attention_kernel(q32, k32, v32, True), iters=5)
    ok32, err32 = held(fa.flash_attention_kernel(q32, k32, v32, True),
                       fa.flash_attention_plain(q32, k32, v32, True), *(FLASH_TOL["float32"],) * 2)
    if not ok32:
        fail(f"f32 flash disagrees with its plain version at BH={bh} S={s_len} D={d}: {err32:.3e}")
    tol = FLASH_TOL["bfloat16"]
    ok, err = held(fa.flash_attention_kernel(q, k, v, True), fa.flash_attention_plain(q, k, v, True),
                   tol, tol)
    if not ok:
        fail(f"flash disagrees with its plain version at BH={bh} S={s_len} D={d}: {err:.3e}")
    q4, k4, v4 = (t.reshape(EVAL_BATCH, 12, s_len, d) for t in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), iters=20)
    nbytes = 4 * bh * s_len * d * 2  # q, k, v read once, out written once
    pairs = s_len * (s_len + 1) // 2  # causal (query, key) pairs per head
    flops = 4 * d * pairs * bh  # q·k and p·v
    bound, by = _bound(nbytes, (flops, BF16_FLOPS))
    print(f"flash timing at BH={bh} S={s_len} D={d} bf16 causal: kernel {ms:.4f} ms (earlier run: "
          f"{EARLIER_MS['flash_attention']} ms), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, "
          f"bound {bound:.5f} ms by {by} ({nbytes} B, {flops} FLOP at the bf16 tensor-core peak; "
          f"{flops / F32_FLOPS * 1e3:.4f} ms at the f32 peak); kernel vs plain max|err| {err:.3e}; "
          f"f32 specialisation on f32 inputs {f32_ms:.4f} ms (max|err| {err32:.3e})", flush=True)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26", "launches": launches,
        "max_abs_err": worst_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": by, "library_ms": library_ms, "bound_peak": "bf16 989 TFLOP/s",
        "shape": f"BH {bh} S {s_len} D {d} bf16 causal", "f32_ms": f32_ms,
    }


def _write_times(cb, c, seed):
    """The KV-page writer at gpt3_126m's serving shapes: 8 rows of ``c``
    tokens (c == 1: a decode tick; c == 64: a prefill chunk, every slot
    of 4 pages a row) of 12 heads of 64, f32 K and V (the serving run's
    compute dtype), into a pool of the serving run's size.  Kernel (event
    loop, device time), plain writer, bound; the two pools must end
    byte-equal."""
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.models import layers

    cfg = BCQConfig()
    b, h, d, ps, n_pages = 8, 12, 64, 16, 1 + 8 * 34
    pool = layers.cache_init(n_pages, ps, h, d, "bcq4", cfg, device="cuda")
    pool["v_sx"].fill_(0.37)
    g = torch.Generator(device="cuda").manual_seed(seed)
    k, v = (torch.randn((b, c, h, d), generator=g, device="cuda") for _ in range(2))
    if c == 1:
        ids = (torch.arange(1, 1 + 3 * b, 3, device="cuda"),
               torch.arange(b, dtype=torch.int32, device="cuda") % ps)
        rows = b
        write = lambda p, kernel: layers.paged_token_write(  # noqa: E731
            p, k, v, *ids, "bcq4", cfg, cb, kernel=kernel)
    else:
        n_cp = c // ps
        ids = (torch.arange(1, 1 + b * n_cp, dtype=torch.int32, device="cuda").reshape(b, n_cp),
               torch.full((b,), c, dtype=torch.int32, device="cuda"))
        rows = b * n_cp * ps
        write = lambda p, kernel: layers.paged_chunk_write(  # noqa: E731
            p, k, v, ids[0], "bcq4", cfg, cb, ids[1], kernel=kernel)
    plain = {n: t.clone() for n, t in pool.items()}
    run = lambda: write(pool, True)  # noqa: E731
    ms = cuda_ms(run)
    plain_ms = cuda_ms(lambda: write(plain, False), iters=10)
    diff = _pool_diff(pool, plain, cb)
    if diff != 0:
        fail(f"the KV-page writer disagrees with the plain writer at C={c} ({diff})")
    nbytes = (2 * k.numel() * 4 + 2 * rows * h * (d // 2 + d // 16 + d // 64)
              + sum(t.numel() * t.element_size() for t in ids) + 8 * 16 * 4 + 8)
    ops = ENCODE_OPS * 2 * k.numel()
    bound, by = _bound(nbytes, (ops, F32_FLOPS))
    dev = device_ms(kernel_split_ms(run, bound, f"the KV-page writer at C={c}"))
    return {"ms": ms, "device_ms": dev, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "nbytes": nbytes, "ops": ops}


def time_quantize(cb, worst_err, launches, write_ties):
    """Quantize at the evaluation's activation shape (8192, 768), and its
    page-store form, the KV writer, at decode and at a prefill chunk."""
    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_quantize as bq
    from repro_torch.kernels.ref import quantize_ref

    cfg = bcq.BCQConfig()
    m, k = EVAL_SEQ * EVAL_BATCH, 768
    x = activation(m, k, 7)
    s_x = bcq.tensor_scale(x, cfg)
    ms = cuda_ms(lambda: bq.bcq_quantize(x, cb, s_x, cfg))
    plain_ms = cuda_ms(lambda: quantize_ref(x, cb, cfg, s_x), iters=5)
    nbytes = m * k * 4 + m * k // 2 + m * k // 16 + m * k // 64 * 4 + 8 * 16 * 4 + 4
    ops = ENCODE_OPS * m * k
    bound, by = _bound(nbytes, (ops, F32_FLOPS))
    dev = device_ms(kernel_split_ms(lambda: bq.bcq_quantize(x, cb, s_x, cfg), bound,
                                    f"bcq_quantize at M={m} K={k}"))
    fmt = lambda v: f"{v:.4f} ms"  # noqa: E731
    print(f"quantize timing at M={m} K={k} (banked-table encode of bcq_encode.cuh): kernel "
          f"{ms:.4f} ms (device {fmt(dev)}, torch.profiler), plain {plain_ms:.4f} ms, bound "
          f"{bound:.5f} ms by {by} ({nbytes} B, {ops} f32 operations); earlier run: device "
          f"{EARLIER_MS['bcq_quantize']} ms", flush=True)
    writes = {}
    for nm, c, seed in (("decode", 1, 61), ("prefill", 64, 62)):
        t = writes[nm] = _write_times(cb, c, seed)
        print(f"KV-page writer timing at {nm} (8 rows × {c} token{'s' if c > 1 else ''} × 12 "
              f"heads × 64, K and V f32, bcq4 pages of 16): kernel {t['ms']:.4f} ms (device "
              f"{fmt(t['device_ms'])}), plain writer {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['nbytes']} B, {t['ops']} f32 "
              f"operations); page bytes equal to the plain writer's", flush=True)
    strip = lambda t: {n: t[n] for n in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}  # noqa: E731
    return {
        "name": "bcq_quantize", "route": "cuda", "source": "src/repro_torch/csrc/bcq_quantize.cu",
        "replaces": "src/repro/kernels/bcq_quantize.py:31", "launches": sum(launches.values()),
        "launches_by_path": launches, "max_abs_err": worst_err, "ms": ms, "device_ms": dev,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
        "bound_peak": "f32 67 TFLOP/s", "shape": f"M {m} K {k}",
        "kv_write_tie_bytes": write_ties,
        "kv_write_at_decode": dict(strip(writes["decode"]), shape="B 8 C 1 H 12 D 64 f32"),
        "kv_write_at_prefill": dict(strip(writes["prefill"]), shape="B 8 C 64 H 12 D 64 f32"),
    }


def time_matmul(cb, worst_err, launches):
    """W4A4 matmul at the evaluation's mlp-in shape, 8192 × 768 → 3072."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_matmul as bm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref

    cfg = bcq.BCQConfig()
    m, k, n = EVAL_SEQ * EVAL_BATCH, 768, 3072
    a = ops.quantize(activation(m, k, 8), cb, cfg)
    _, w = linear_case(8, k, n, 9, cb)
    args = (a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed, w.sel_packed, w.inv_scale,
            cb, cb, cfg)
    ms = cuda_ms(lambda: bm.bcq_matmul(*args), iters=10)
    plain_ms = cuda_ms(lambda: matmul_ref(*args), iters=5)
    xb = torch.randn((m, k), device="cuda").to(torch.bfloat16)
    wb = torch.randn((k, n), device="cuda").to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.matmul(xb, wb))
    nbytes = (m + n) * (k // 2 + k // 16 + k // 64 * 4) + 2 * 8 * 16 * 4 + m * n * 4
    bound, by = _bound(nbytes, (2 * m * n * k, INT8_OPS))
    dev = device_ms(kernel_split_ms(lambda: bm.bcq_matmul(*args), bound,
                                    f"bcq_matmul at M={m} K={k} N={n}"))
    print(f"matmul timing at M={m} K={k} N={n}: kernel {ms:.4f} ms (device "
          f"{dev:.4f} ms, torch.profiler), plain {plain_ms:.4f} ms, "
          f"torch.matmul bf16 {library_ms:.4f} ms, bound {bound:.5f} ms by {by} ({nbytes} B, "
          f"{2 * m * n * k} OP at the int8 tensor-core peak; {2 * m * n * k / F32_FLOPS * 1e3:.5f} ms "
          f"at the f32 peak); earlier run: {EARLIER_MS['bcq_matmul']} ms", flush=True)
    return {
        "name": "bcq_matmul", "route": "cuda", "source": "src/repro_torch/csrc/bcq_matmul.cu",
        "replaces": "src/repro/kernels/bcq_matmul.py:52", "launches": launches,
        "max_abs_err": worst_err, "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
        "bound_peak": "int8 tensor cores 1979 TOP/s", "shape": f"M {m} K {k} N {n}",
    }


def check_bounds(kernels):
    """No time in the ``kernels`` line may read below its bound: the card
    cannot do the work faster, so such a reading is a measurement fault."""
    for entry in kernels:
        for at in [entry] + [v for v in entry.values() if isinstance(v, dict) and "bound_ms" in v]:
            for key in ("ms", "device_ms"):
                if at.get(key) is not None and at[key] < at["bound_ms"]:
                    fail(f"{entry['name']} ({at.get('shape')}): {key} {at[key]:.5f} reads below "
                         f"its bound {at['bound_ms']:.5f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core.calibrate import default_universal_codebooks
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f}s", flush=True)
    log = (build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"  {line.strip()}", flush=True)

    cb = default_universal_codebooks().as_tensor("cuda")
    err_lin = phase_linear(cb)
    err_gat = phase_gather(cb)
    eng4, counts, err_w, tol = phase_serving()
    err_fl = phase_flash()
    err_q = phase_quantize(cb)
    err_mm = phase_matmul(cb)
    counts_2l, err_2l = phase_two_launch(cb)
    counts_ev, err_ev, _ = phase_eval()
    kernels = [
        time_linear(cb, max(err_lin, err_ev["bcq_linear"]),
                    {"serving": counts["bcq_linear"], "evaluation": counts_ev["bcq_linear"]}),
        time_gather(cb, err_gat, {"serving": counts["page_gather"]}),
        time_flash(max(err_fl, err_ev["flash_attention"]), counts_ev["flash_attention"]),
        time_quantize(cb, err_q, {"two_launch": counts_2l["bcq_quantize"],
                                  "serving": counts["bcq_page_write"]}, err_w),
        time_matmul(cb, max(err_mm, err_2l), counts_2l["bcq_matmul"]),
    ]
    # phase 11 after the timings: a profiler window after its runs has read
    # kernels short (device times below their bounds)
    counts_core, err_slab, core = phase_core(eng4, tol)
    counts_prod, g2, core_g2 = phase_production(eng4, tol, core)
    counts_contain = phase_containment(eng4, tol, core, g2, smi)
    counts_tel, probe_form = phase_telemetry(eng4, cb, g2, core_g2, smi)
    counts_tier, _ = phase_host_tier(eng4, tol, core, g2, core_g2, smi)
    counts_moe, stacked, err_moe = phase_moe(cb, smi)
    counts_ptq, err_ptq, fake_form = phase_ptq(cb, smi)
    for entry, counter in zip(kernels, ("bcq_linear", "page_gather", None, "bcq_page_write")):
        if counter is not None:
            entry["launches_by_path"]["serving_core"] = counts_core[counter]
            entry["launches_by_path"]["production_tick"] = counts_prod[counter]
            entry["launches_by_path"]["containment"] = counts_contain[counter]
            entry["launches_by_path"]["telemetry"] = counts_tel[counter]
            entry["launches_by_path"]["host_tier"] = counts_tier[counter]
            entry["launches_by_path"]["moe"] = counts_moe[counter]
            entry["launches_by_path"]["ptq"] = counts_ptq.get(counter, 0)
            entry["launches"] = sum(entry["launches_by_path"].values())
    kernels[2]["launches_by_path"] = {"evaluation": kernels[2]["launches"],
                                      "ptq": counts_ptq.get("flash_attention", 0)}
    kernels[2]["launches"] = sum(kernels[2]["launches_by_path"].values())
    kernels[3]["launches_by_path"]["probes"] = counts_tel["bcq_quantize"]
    kernels[3]["launches_by_path"]["ptq_fake_quant"] = counts_ptq.get("bcq_quantize", 0)
    kernels[3]["launches"] = sum(kernels[3]["launches_by_path"].values())
    kernels[3]["probe_form"] = probe_form
    kernels[3]["fake_quant_form"] = fake_form
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], err_slab, err_moe["bcq_linear"],
                                    err_ptq["bcq_linear"])
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], err_moe["page_gather"],
                                    err_ptq["page_gather"])
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], err_ptq["flash_attention"])
    kernels.insert(1, stacked)
    check_bounds(kernels)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
