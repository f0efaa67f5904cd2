#!/usr/bin/env python3
"""The default format's compiled kernel paths timed against the general
paths that every other LO-BCQ format takes, on one NVIDIA GPU.

    python3 chip_route_study.py [--out chiprun_out/route_study.json]

In the default format (L_A 64, L_b 8, 16 entries, N_c 8) the kernels have
compiled-in paths beside the general ones (``core/bcq.kernel_route``):
B3's threshold search on trained books (SEARCH8 vs SEARCH), B1's and B4's
GEMM (the specialised GEMM vs ``gemm_fmt``) and B2's bcq4 read (kind 2 vs
kind 3).  Each pair runs through its wrapper on the same seeded inputs at
``chip_smoke.py``'s phase-10 shapes, the route forced by replacing the
wrapper module's ``kernel_route``; the outputs must be bit-equal, and each
is timed in turns (compiled, general, general, compiled): device ms per
call (torch.profiler) and the event loop.  Not part of the smoke.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import chip_smoke as cs


@contextlib.contextmanager
def forced_route(module, table=None, special=None):
    """``module.kernel_route`` answering ``special`` (and ``table``, where
    given) whatever the format: the route a wrapper passes to its C entry."""
    real = module.kernel_route

    def route(cfg, integer=True):
        r = real(cfg, integer)
        return r._replace(table=r.table if table is None else table,
                          special=r.special if special is None else special)

    module.kernel_route = route
    try:
        yield
    finally:
        module.kernel_route = real


def pair(name, module, run, routes):
    """Run ``run`` under each of the two ``routes`` (kwargs of
    ``forced_route``): outputs bit-equal, then timed in turns.  Returns the
    row of numbers."""
    import torch

    outs = []
    for r in routes:
        with forced_route(module, **r):
            got = run()
            torch.cuda.synchronize()
            outs.append([t.clone() for t in (got if isinstance(got, tuple) else (got,))])
    equal = all(torch.equal(a, b) for a, b in zip(*outs))
    if not equal:
        cs.fail(f"{name}: the compiled and the general route give other bits")
    times = {0: [], 1: []}
    for i in (0, 1, 1, 0):
        with forced_route(module, **routes[i]):
            by_name = cs.kernel_split_ms(run, 0.0, f"{name} route {i}", iters=20)
            times[i].append((cs.device_ms(by_name), cs.timer(by_name),
                             cs.cuda_ms(run, iters=20)))
    row = {"name": name, "bits_equal": equal}
    for i, label in ((0, "compiled"), (1, "general")):
        row[label] = {"device_ms": [d for d, _, _ in times[i]],
                      "timer": sorted({t for _, t, _ in times[i]}),
                      "event_ms": [e for _, _, e in times[i]]}
    dev = [sum(row[lb]["device_ms"]) / 2 for lb in ("compiled", "general")]
    row["general_over_compiled"] = dev[1] / dev[0]
    print(f"{name}: device ms compiled {row['compiled']['device_ms']} | general "
          f"{row['general']['device_ms']} (general / compiled {row['general_over_compiled']:.3f});"
          f" event loop {row['compiled']['event_ms']} | {row['general']['event_ms']}; "
          f"bits equal", flush=True)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_route_study: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "route_study.json"))
    args = ap.parse_args()

    from repro_torch.core import bcq
    from repro_torch.core.calibrate import default_universal_codebooks
    from repro_torch.kernels import bcq_linear as bl
    from repro_torch.kernels import bcq_matmul as bm
    from repro_torch.kernels import bcq_quantize as bq
    from repro_torch.kernels import build, common, ops
    from repro_torch.kernels.ref import quantize_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build + load: {build_s:.1f}s", flush=True)
    cfg = bcq.BCQConfig()
    cb = default_universal_codebooks().as_tensor("cuda")
    g = torch.Generator().manual_seed(0)
    # trained books: the universal ones moved off the integers, still sorted
    books = torch.sort(cb.cpu() + 0.01 * torch.randn(cb.shape, generator=g), dim=1)[0].cuda()
    m_ev = cs.EVAL_SEQ * cs.EVAL_BATCH
    rows = []

    x = cs.activation(m_ev, 768, 7)
    s_x = bcq.tensor_scale(x, cfg)
    run = lambda: bq.bcq_quantize(x, books, s_x, cfg)  # noqa: E731
    rows.append(pair(f"B3 threshold search, trained books, M {m_ev} K 768", bq, run,
                     ({"special": True}, {"special": False})))
    ref = quantize_ref(x, books, cfg, s_x)
    same = [bool(torch.equal(a, b)) for a, b in zip(run(), ref)]
    rows[-1]["equal_to_quantize_ref"] = same
    print(f"  idx, sel, ratio equal to quantize_ref: {same}", flush=True)

    for m, k, n, seed in ((8, 768, 3072, 99), (m_ev, 768, 3072, 98), (m_ev, 3072, 768, 97)):
        xl, w = cs.linear_case(m, k, n, seed, cb)
        sl = bcq.tensor_scale(xl, cfg)
        run = lambda: bl.bcq_linear(xl, w.idx_packed, w.sel_packed, w.inv_scale, cb, sl,  # noqa: E731
                                    cfg)
        rows.append(pair(f"B1 M {m} K {k} N {n}", bl, run,
                         ({"special": True}, {"special": False})))

    a = ops.quantize(cs.activation(m_ev, 768, 8), cb, cfg)
    _, w = cs.linear_case(8, 768, 3072, 9, cb)
    run = lambda: bm.bcq_matmul(a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed,  # noqa: E731
                                w.sel_packed, w.inv_scale, cb, cb, cfg)
    rows.append(pair(f"B4 M {m_ev} K 768 N 3072", bm, run,
                     ({"special": True}, {"special": False})))

    for c, kv_len, seed in ((1, [n + cs.GEN for n in cs.PROMPT_LENS], 5), (64, [500] * 8, 15)):
        ps, b, h, d = 16, len(kv_len), 12, 64
        maxp = -(-max(kv_len) // ps)
        n_pages = 1 + b * maxp
        pool = cs.gather_pool("bcq4", n_pages, ps, h, d, seed, cb, cfg)
        bt, kvl = cs.gather_case(b, maxp, ps, kv_len, seed + 1, n_pages)
        q = torch.randn((b, c, h, d), generator=torch.Generator().manual_seed(seed + 2)).cuda()
        run = lambda: common.page_gather_attention(q, pool, bt, kvl, "bcq4", cfg, cb)  # noqa: E731
        rows.append(pair(f"B2 bcq4 B {b} C {c} H {h} D {d} kv {max(kv_len)}", common, run,
                         ({"special": True}, {"special": False})))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "build_s": build_s, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
