#!/usr/bin/env python3
"""The contiguous decode's cache read on the card: the written prefix (the
port's ``layers.cache_read(valid_len=cache_pos + S)``) against the whole
cache dequantized, then sliced to the prefix (the reference's
static-shape read), in the ``ContinuousBatcher`` runs of ``chip_smoke.py``
phase 22.

    python3 chip_read_study.py [--archs qwen2_0_5b ...] [--gen 4]
                               [--out chiprun_out/read_study.json]

Each model at full width and depth: seeded W4 weights, a bcq4 cache and
f32 compute, as phase 22; phase 4's eight prompts (48–500 tokens),
``--gen`` tokens a request, one slot a request over phase 4's max_len.
After a warm-up run, the runs go prefix, whole, whole, prefix in one
process, and the two reads' tokens must be equal; then one run of each
read under torch.profiler gives the device's busy ms (the profiler's
post-processing of a run's ~275,000 kernels takes minutes at Qwen2-0.5B's
24 layers: give a deeper model a long time limit).  Needs one CUDA card
and the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs


@contextlib.contextmanager
def whole_read():
    """Within the block the slab read dequantizes every position of the
    cache, then keeps the first ``valid_len``."""
    from repro_torch.models import layers

    real = layers.cache_read

    def read(cache, kind, cfg, cb, dtype, valid_len=None):
        k, v = real(cache, kind, cfg, cb, dtype)
        return (k, v) if valid_len is None else (k[:, :valid_len], v[:, :valid_len])

    layers.cache_read = read
    try:
        yield
    finally:
        layers.cache_read = real


def batcher_run(api, params, prompts, gen):
    """(wall s, rid → tokens) of one ``ContinuousBatcher`` run."""
    import torch

    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.serving.generate import Request

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bat = ContinuousBatcher(api, params, n_slots=len(prompts), max_len=cs.MOE_MAX_LEN)
    for i, p in enumerate(prompts):
        bat.submit(Request(rid=i, prompt=p, max_new=gen - 1))
    finished, _ = bat.run_to_completion()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {r.rid: list(r.out) for r in finished}


def study(arch, gen):
    import torch

    from repro_torch.configs.base import get_arch

    cfg = get_arch(arch)
    prompts = [np.random.default_rng(0).integers(0, cfg.vocab, n) for n in cs.PROMPT_LENS]
    api, params, init_s, gb = cs._zoo_build(cfg)
    reads = {"prefix": contextlib.nullcontext, "whole": whole_read}
    batcher_run(api, params, prompts, gen)  # warm-up
    walls = {"prefix": [], "whole": []}
    tokens = {}
    for name in ("prefix", "whole", "whole", "prefix"):
        with reads[name]():
            wall, toks = batcher_run(api, params, prompts, gen)
        walls[name].append(wall)
        if tokens.setdefault(name, toks) != toks:
            cs.fail(f"{arch}: two {name} runs gave different tokens")
    if tokens["prefix"] != tokens["whole"]:
        cs.fail(f"{arch}: the prefix and the whole read gave different tokens")
    busy = {}
    for name, read in reads.items():
        with read():
            prof = cs._device_kernels(lambda: batcher_run(api, params, prompts, gen))
        busy[name] = None if prof is None else {"kernels": prof[0], "busy_ms": prof[1]}
    out = {"arch": arch, "init_s": init_s, "resident_gb": gb, "gen": gen,
           "wall_s": walls, "device": busy, "tokens_equal": True}
    print(f"{cfg.name}: ContinuousBatcher, 8 prompts of 48–500 tokens, {gen} tokens each: wall s "
          f"prefix {walls['prefix']}, whole {walls['whole']} (order prefix, whole, whole, "
          f"prefix); one profiled run each: {busy}; tokens equal", flush=True)
    del api, params
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_read_study: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="+", default=["qwen2_0_5b"])
    ap.add_argument("--gen", type=int, default=cs.ZOO_BATCHER_GEN)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "read_study.json"))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    from repro_torch.kernels import build

    build.library()
    res = {"card": smi, "runs": [study(a, args.gen) for a in args.archs]}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
