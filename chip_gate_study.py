#!/usr/bin/env python3
"""How the W4A4 evaluation loss gate of ``chip_smoke.py`` phase 9 responds
to the fused linear (B1): the real kernel, its plain f32 oracle, and
deliberately faulty versions of it.

    python3 chip_gate_study.py [--out chiprun_out/gate_study.json]

Full-width gpt3_126m in W4A4 (seeded random weights packed to W4), bf16
compute, the flash kernel, on the two held-out batches of phase 9.  The
plain path's losses on the original weights and its NUDGES nudged copies
are taken once; then, for each version of B1 (swapped in for
``ops.bcq_linear``), the kernel path's losses on the same inputs.  For each
version it prints the gate's reading (the paired mean offset against
twice the mean noise floor) and how many of the single-draw readings (the
original weights against one nudge's floor, the form of the gate through
its first version) would have failed.  Needs one CUDA card and the
repository's ``src/``; ``chip_smoke.py`` holds the kernels themselves.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import chip_smoke as cs


def versions():
    """Versions of B1 by name: (x, w_idx, w_sel, w_inv, cb, s_x, cfg) → y."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fused_linear_ref

    kernel = ops.bcq_linear

    def drop_last_array(x, *a):
        x = x.clone()
        x[:, -64:] = 0  # the same s_x: the last 64-wide array contributes nothing
        return kernel(x, *a)

    return {
        "kernel": kernel,
        "f32 oracle": lambda x, wi, ws, wv, cb, s_x, cfg: fused_linear_ref(
            x, wi, ws, wv, cb, cfg, s_x, valid_k=x.shape[1]),
        "kernel × (1 + 2^-8)": lambda *a: kernel(*a) * (1 + 2**-8),
        "kernel × (1 − 2^-8)": lambda *a: kernel(*a) * (1 - 2**-8),
        "kernel × (1 + 2^-6)": lambda *a: kernel(*a) * (1 + 2**-6),
        "kernel, last array dropped": drop_last_array,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_gate_study: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "gate_study.json"))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, eval_stream
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    cfg = get_arch("gpt3_126m")
    dc = DataConfig(vocab=cfg.vocab, seq_len=cs.EVAL_SEQ, global_batch=cs.EVAL_BATCH)
    batches = list(eval_stream(dc, cs.EVAL_BATCHES, device="cuda"))
    rt_k = Runtime(quant_mode="packed", compute_dtype=torch.bfloat16, flash_kernel=True)
    rt_p = dataclasses.replace(rt_k, flash_kernel=False, fused_linear=False)
    api_k, api_p = (zoo.build(cfg, rt, device="cuda") for rt in (rt_k, rt_p))
    params = api_k.init(0)

    rs = range(cs.NUDGES + 1)  # r = 0: the original weights
    lp = [sum(cs._eval_losses(api_p, params, batches)[0]) / cs.EVAL_BATCHES]
    lp += cs.path_losses(api_p, params, batches, rs[1:])
    floors = [abs(p - lp[0]) for p in lp[1:]]
    floor = sum(floors) / len(floors)
    print(f"plain path: loss {lp[0]:.6f}; |Δloss| under each nudge "
          f"{', '.join(f'{f:.3e}' for f in floors)}; noise floor (mean) {floor:.3e}", flush=True)

    report = {"plain_losses": lp, "floors": floors, "floor": floor, "versions": {}}
    kernel = ops.bcq_linear
    for name, fn in versions().items():
        ops.bcq_linear = fn
        try:
            lk = [sum(cs._eval_losses(api_k, params, batches)[0]) / cs.EVAL_BATCHES]
            lk += cs.path_losses(api_k, params, batches, rs[1:])
        finally:
            ops.bcq_linear = kernel
        paired = [k - p for k, p in zip(lk, lp)]
        gap = abs(sum(paired) / len(paired))
        one_draw_fails = sum(abs(paired[0]) > 2 * f for f in floors)
        report["versions"][name] = {"kernel_losses": lk, "paired": paired, "gap": gap,
                                    "gate_holds": gap <= 2 * floor,
                                    "one_draw_fails": one_draw_fails}
        print(f"{name:28s}: paired Δloss {', '.join(f'{d:+.3e}' for d in paired)}; gate |mean| "
              f"{gap:.3e} vs 2 × floor {2 * floor:.3e}: {'holds' if gap <= 2 * floor else 'FAILS'}; "
              f"one-draw form fails under {one_draw_fails} of {len(floors)} nudges", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
