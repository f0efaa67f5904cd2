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
   d_head 64 and 32, GQA, NULL-padded tables, zero-length rows, rows of
   up to 40 pages (five splits).
4. serving: full-width gpt3_126m (12 layers, seeded random weights packed
   to W4 by the port's pack_params) through PagedEngine — bcq4 pool,
   page 16, prefill chunk 64, 8 slots, 8 requests of 48–500 prompt
   tokens, 32 new tokens each — once through the kernels and once
   through the plain paths.  Every kernel must have launched layers ×
   per-layer × forward passes times in the kernel run; the two paths'
   logits on identical inputs must agree (to rounding without W4A4, to
   twice the plain path's own 1-ulp noise floor with it); greedy tokens
   must agree under the margin rule; then one steady decode tick is
   timed and traced.
5. flash attention kernel vs its plain version: bf16 (tensor cores) and
   f32 (CUDA cores), causal and full, S ∈ {128, 384, 2048, 200}, d_head ∈
   {32, 64, 128}, GQA through the (B, S, H, D) wrapper.
6. quantize kernel vs ``quantize_ref`` at (8192, 768), (8192, 3072) and a
   ragged (37, 192): bytes equal (decoded values equal on a codebook
   tie), ratios exactly equal.
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
    shape; flash in bf16 and its f32 specialisation; each printed line
    names the kernel's time in an earlier run (``EARLIER_MS``); a
    ``kernels`` JSON line (launches, error, times, bound), the card's name
    and power limit, then the device line as the last line.

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
# PERF.md's kernel table), printed beside this run's.
EARLIER_MS = {"bcq_linear": {(8, 768, 3072): 0.0471, (8192, 768, 3072): 0.2418,
                          (8192, 3072, 768): 0.2931},
           "page_gather": 0.2148, "flash_attention": 1.2186, "bcq_quantize": 0.0617,
           "bcq_matmul": 0.2746}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
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
        for d, h, hkv in ((64, 12, 12), (32, 4, 2)):
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
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve

    build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finished, eng = serve(cfg, prompts, GEN, cache="bcq4", packed=True, page_size=16,
                          prefill_chunk=64, device="cuda", seed=0, kernels=kernels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.counts()
    st = eng.stats
    label = "kernels" if kernels else "plain  "
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
    expect = {"bcq_linear": cfg.n_layers * 6 * passes, "page_gather": cfg.n_layers * passes}
    for name, n in expect.items():
        if counts.get(name, 0) != n or n == 0:
            fail(f"{name} launched {counts.get(name, 0)} times in the kernel run, expected {n}")
        if counts_p.get(name, 0):
            fail(f"{name} launched in the plain run")
    print(f"launch counts match layers × per-layer × passes: {expect} "
          f"({cfg.n_layers} layers, {passes} forward passes)", flush=True)
    tol = phase_logits(eng_k, eng_p, prompts, [r.out[0] for r in sorted(fin_p, key=lambda r: r.rid)])
    agree = greedy_agreement({r.rid: r for r in fin_p}, {r.rid: r for r in fin_k}, tol)
    margins = np.concatenate([r.margins for r in fin_p])
    print(f"greedy tokens kernels vs plain (margin rule, logit tol {tol:.3e} = the noise "
          f"floor): {agree}; plain-run top-2 margins min {margins.min():.4f} "
          f"median {np.median(margins):.4f}", flush=True)
    profile_decode(eng_k, prompts)
    if not agree["ok"]:
        fail("greedy tokens of the kernel run and the plain run disagree beyond the margin rule")
    return eng_k, counts


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


def profile_decode(eng_done, prompts):
    """Where a steady decode tick's time goes: a fresh engine on the same
    model is stepped until every request decodes, then 3 ticks are timed
    (host clock, synchronized) and 3 more traced with torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.generate import Request

    eng = PagedEngine(eng_done.api, eng_done.params, n_slots=len(prompts),
                      max_len=eng_done.max_len, page_size=16, prefill_chunk=64, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=GEN - 1))
    while eng.queue or any(s.mode == "prefill" for s in eng.slots if s.req is not None):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 3 / 1e3
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 3 / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if not kern:
        print(f"decode tick profile: wall {wall:.2f} ms/tick; the profiler saw no device "
              f"kernels (device time not measured)", flush=True)
        return
    print(f"decode tick profile (8 rows decoding): wall {wall:.2f} ms/tick unprofiled, "
          f"{len(kern) / 3:.0f} CUDA kernels/tick, device busy {busy:.2f} ms/tick "
          f"(idle share {max(0.0, 1 - busy / wall):.3f})", flush=True)
    for name, ms in top:
        print(f"  {ms:8.3f} ms/tick  {name[:90]}", flush=True)


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
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        api.loss_fn(params, batch)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print("eval forward profile: the profiler saw no device kernels (device time not "
              "measured)", flush=True)
        return None
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    idle = max(0.0, 1 - busy / wall_ms)
    print(f"eval forward profile: wall {wall_ms:.1f} ms unprofiled, {len(kern)} CUDA kernels, "
          f"device busy {busy:.1f} ms (idle share {idle:.3f})", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} ms  {ms / busy:6.1%}  {name[:90]}", flush=True)
    return idle


# ------------------------------------------------------------------ phase 10
def _bound(nbytes, *work):
    """The least time (ms) for ``nbytes`` of HBM traffic and the ``(ops,
    peak per second)`` pairs of ``work`` (each on its own units, which run
    side by side), and which of bytes and operations bounds it."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max(ops / peak * 1e3 for ops, peak in work)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


ENCODE_OPS = 8 * (1 + 3)  # per scalar and codebook: a table read, d, d², Σ


def kernel_split_ms(fn, iters=10):
    """Device ms per call of each CUDA kernel ``fn`` launches, by name
    (torch.profiler over ``iters`` calls after a warm-up), or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return by_name or None


def device_ms(by_name):
    """Device ms per call summed over a call's kernels (None: not measured).
    Where a call's device work is a few microseconds, back-to-back calls
    are paced by the host, and ``cuda_ms`` measures that pace instead."""
    return None if by_name is None else sum(by_name.values())


def _linear_split(by_name):
    """B1's two device kernels: encode pass and GEMM, ms per call."""
    if by_name is None:
        return {"encode_ms": None, "gemm_ms": None, "device_ms": None}
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
    split = _linear_split(kernel_split_ms(lambda: bl.bcq_linear(*args, s_x, cfg)))
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
    by_name = kernel_split_ms(lambda: common.page_gather_attention(*run))
    dev = device_ms(by_name)
    pick = lambda key: None if by_name is None else sum(  # noqa: E731
        t for nm, t in by_name.items() if key in nm)
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
    return {"ms": ms, "device_ms": dev, "split_ms": pick("split_kernel"),
            "combine_ms": pick("combine_kernel"), "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "nbytes": nbytes, "flops": flops, "err": err}


def time_gather(cb, worst_err, launches):
    kv_dec = [n + GEN for n in PROMPT_LENS]  # decode at the end of the serving run
    dec = _gather_times(cb, 1, kv_dec, 5)
    kv_pre = [500] * 8  # a full prefill chunk of 8 rows at the longest prompt
    pre = _gather_times(cb, 64, kv_pre, 15)
    for nm, t, shape in (("decode", dec, f"B=8 C=1 kv_len={kv_dec}"),
                         ("chunked prefill", pre, "B=8 C=64 kv_len=500")):
        dev = "not measured" if t["device_ms"] is None else (
            f"{t['device_ms']:.4f} ms = split {t['split_ms']:.4f} + combine {t['combine_ms']:.4f}")
        print(f"page_gather timing at {nm} {shape} H=12 D=64 bcq4: kernel {t['ms']:.4f} ms "
              f"(device {dev}, torch.profiler), plain {t['plain_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({t['nbytes']} B, "
              f"{t['flops']} f32 FLOP); kernel vs plain max|err| {t['err']:.3e}"
              + (f"; earlier run: {EARLIER_MS['page_gather']} ms" if nm == "decode" else ""), flush=True)
    strip = lambda t: {k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}  # noqa: E731
    return {
        "name": "page_gather", "route": "cuda", "source": "src/repro_torch/csrc/page_gather.cu",
        "replaces": "src/repro/kernels/common.py:265", "launches": launches,
        "max_abs_err": worst_err, **strip(dec), "library_ms": None,
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


def time_quantize(cb, worst_err, launches):
    """Quantize at the evaluation's activation shape (8192, 768)."""
    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_quantize as bq
    from repro_torch.kernels.ref import quantize_ref

    cfg = bcq.BCQConfig()
    m, k = EVAL_SEQ * EVAL_BATCH, 768
    x = activation(m, k, 7)
    s_x = bcq.tensor_scale(x, cfg)
    ms = cuda_ms(lambda: bq.bcq_quantize(x, cb, s_x, cfg))
    dev = device_ms(kernel_split_ms(lambda: bq.bcq_quantize(x, cb, s_x, cfg)))
    plain_ms = cuda_ms(lambda: quantize_ref(x, cb, cfg, s_x), iters=5)
    nbytes = m * k * 4 + m * k // 2 + m * k // 16 + m * k // 64 * 4 + 8 * 16 * 4 + 4
    ops = ENCODE_OPS * m * k
    bound, by = _bound(nbytes, (ops, F32_FLOPS))
    print(f"quantize timing at M={m} K={k} (table encode of bcq_encode.cuh): kernel {ms:.4f} ms "
          f"(device {dev if dev is None else f'{dev:.4f}'} ms, torch.profiler), plain "
          f"{plain_ms:.4f} ms, bound {bound:.5f} ms by {by} ({nbytes} B, {ops} f32 operations); "
          f"earlier run: {EARLIER_MS['bcq_quantize']} ms", flush=True)
    return {
        "name": "bcq_quantize", "route": "cuda", "source": "src/repro_torch/csrc/bcq_quantize.cu",
        "replaces": "src/repro/kernels/bcq_quantize.py:31", "launches": launches,
        "max_abs_err": worst_err, "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None, "bound_peak": "f32 67 TFLOP/s",
        "shape": f"M {m} K {k}",
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
    dev = device_ms(kernel_split_ms(lambda: bm.bcq_matmul(*args)))
    plain_ms = cuda_ms(lambda: matmul_ref(*args), iters=5)
    xb = torch.randn((m, k), device="cuda").to(torch.bfloat16)
    wb = torch.randn((k, n), device="cuda").to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.matmul(xb, wb))
    nbytes = (m + n) * (k // 2 + k // 16 + k // 64 * 4) + 2 * 8 * 16 * 4 + m * n * 4
    bound, by = _bound(nbytes, (2 * m * n * k, INT8_OPS))
    print(f"matmul timing at M={m} K={k} N={n}: kernel {ms:.4f} ms (device "
          f"{dev if dev is None else f'{dev:.4f}'} ms, torch.profiler), plain {plain_ms:.4f} ms, "
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
    _, counts = phase_serving()
    err_fl = phase_flash()
    err_q = phase_quantize(cb)
    err_mm = phase_matmul(cb)
    counts_2l, err_2l = phase_two_launch(cb)
    counts_ev, err_ev, _ = phase_eval()
    kernels = [
        time_linear(cb, max(err_lin, err_ev["bcq_linear"]),
                    {"serving": counts["bcq_linear"], "evaluation": counts_ev["bcq_linear"]}),
        time_gather(cb, err_gat, counts["page_gather"]),
        time_flash(max(err_fl, err_ev["flash_attention"]), counts_ev["flash_attention"]),
        time_quantize(cb, err_q, counts_2l["bcq_quantize"]),
        time_matmul(cb, max(err_mm, err_2l), counts_2l["bcq_matmul"]),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
