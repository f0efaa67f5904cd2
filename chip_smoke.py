#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; the last line is printed only on
success):

1. device: name, power limit and count; build of the CUDA kernels
   (csrc/*.cu, one nvcc per source) and the ptxas register report.
2. fused W4A4 linear kernel vs its plain PyTorch version at the serving
   shapes of gpt3_126m.
3. page-gather attention kernel vs its plain version: bf16 / int8 / bcq4
   pages, C = 1 and 64, d_head 64 and 32, GQA, NULL-padded tables,
   zero-length rows.
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
5. a ``kernels`` JSON line (launches, error, times, bound), the card's
   name and power limit, then the device line as the last line.

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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and f32 FLOP/s
# on the CUDA cores (both kernels multiply-add in f32 outside the tensor
# cores).  Stated at the 700 W limit.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12

LINEAR_TOL = 1e-5  # rtol, and atol as a multiple of max|plain| (f32 sum order)
GATHER_TOL = 2e-5  # atol = rtol, as tests/test_paged_kernel.py


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


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
def time_linear(cb, worst_err, launches):
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_linear as bl
    from repro_torch.kernels.ref import fused_linear_ref

    cfg = bcq.BCQConfig()
    m, k, n = 8, 768, 3072  # decode mlp-in: n_slots rows
    x, w = linear_case(m, k, n, 99, cb)
    s_x = bcq.tensor_scale(x, cfg)
    args = (x, w.idx_packed, w.sel_packed, w.inv_scale, cb)
    ms = cuda_ms(lambda: bl.bcq_linear(*args, s_x, cfg))
    plain_ms = cuda_ms(lambda: fused_linear_ref(*args, cfg, s_x, valid_k=k), iters=10)
    xb = x.to(torch.bfloat16)
    wb = torch.randn((k, n)).cuda().to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.matmul(xb, wb))
    nbytes = m * k * 4 + n * k // 2 + n * k // 16 + n * k // 64 * 4 + 8 * 16 * 4 + 4 + m * n * 4
    flops = 2 * m * n * k
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    print(f"bcq_linear timing at M={m} K={k} N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.matmul bf16 {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms "
          f"({nbytes} B, {flops} f32 FLOP)", flush=True)
    return {
        "name": "bcq_linear", "route": "cuda", "source": "src/repro_torch/csrc/bcq_linear.cu",
        "replaces": "src/repro/kernels/bcq_linear.py:81", "launches": launches,
        "max_abs_err": worst_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def time_gather(cb, worst_err, launches):
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.kernels import common

    cfg = BCQConfig()
    ps, hkv, d = 16, 12, 64
    kv_len = [n + GEN for n in PROMPT_LENS]  # decode at the end of the serving run
    b = len(kv_len)
    maxp = -(-max(kv_len) // ps)
    n_pages = 1 + b * maxp
    pool = gather_pool("bcq4", n_pages, ps, hkv, d, 5, cb)
    bt, kvl = gather_case(b, maxp, ps, kv_len, 6, n_pages)
    q = torch.randn((b, 1, hkv, d)).cuda()
    run = (q, pool, bt, kvl, "bcq4", cfg, cb)
    ms = cuda_ms(lambda: common.page_gather_attention(*run))
    plain_ms = cuda_ms(lambda: common.page_gather_attention_plain(*run), iters=10)
    pages = sum(max(1, -(-n // ps)) for n in kv_len)
    page_bytes = ps * hkv * (d // 2 + d // 16 + d // 64)  # one K or V page
    nbytes = q.numel() * 4 * 2 + 2 * pages * page_bytes + bt.numel() * 4 + b * 4 + 8 * 16 * 4 + 8
    flops = 4 * hkv * d * pages * ps  # QK and PV, C = 1, H = Hkv
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    print(f"page_gather timing at decode B={b} H={hkv} D={d} bcq4 kv_len={kv_len}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms "
          f"({nbytes} B, {flops} f32 FLOP)", flush=True)
    return {
        "name": "page_gather", "route": "cuda", "source": "src/repro_torch/csrc/page_gather.cu",
        "replaces": "src/repro/kernels/common.py:265", "launches": launches,
        "max_abs_err": worst_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
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
    kernels = [
        time_linear(cb, err_lin, counts["bcq_linear"]),
        time_gather(cb, err_gat, counts["page_gather"]),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
