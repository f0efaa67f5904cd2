#!/usr/bin/env python3
"""Two measurements of the training step on one NVIDIA GPU, not part of
``chip_smoke.py``:

    python3 chip_train_study.py step [--tree DIR] [default chunk2048 bf16]
    python3 chip_train_study.py memory ARCH LAYERS [--nondeterministic] [--expandable]

``step``: ms/step and peak memory of full-width gpt3_126m's train step
(``launch.train.make_train_step``: 4 × 2048 tokens, bf16 compute on f32
params, the deterministic algorithms on, 5 steps after one warm-up from
fresh weights) for each ``Runtime`` variant named — ``default`` (query
chunks of 1,024, f32 scores), ``chunk2048`` (one chunk), ``bf16``
(``attn_f32=False``) — in the checkout ``--tree`` names (default this
one; variants its ``Runtime`` lacks are skipped).  To compare two
commits, unpack the other with ``git archive`` under the ignored
``build/`` and run the two in turns (parent, change, change, parent).
Prints one JSON line.

``memory``: allocated / peak / reserved GB after each stage of one train
step of ARCH cut to LAYERS layers at full width (2 × 512 tokens, the
CLI's Runtime): ``init_train``, AdamW's state, the gradient, the update;
``--expandable`` turns on the allocator's expandable segments first.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANTS = {"default": {}, "chunk2048": {"attn_chunk": 2048}, "bf16": {"attn_f32": False}}


def step_times(variants):
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import adamw

    cfg = get_arch("gpt3_126m")
    fields = {f.name for f in dataclasses.fields(Runtime)}
    params = zoo.build(cfg, Runtime(), device="cuda").init_train(0)
    opt = adamw.init_state(params)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=2048, global_batch=4, seed=0), 0,
                     device="cuda")
    out = {}
    for name in variants:
        kw = VARIANTS[name]
        if not set(kw) <= fields:
            continue
        step = train.make_train_step(zoo.build(cfg, Runtime(**kw), device="cuda"),
                                     adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=200))
        with train.deterministic():
            step(params, opt, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(5):
                r = step(params, opt, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 5
        out[name] = {"ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "loss": float(r[2]["loss"])}
        del r
    return out


def step_memory(arch, layers, det, expandable):
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import adamw

    if expandable:
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")

    def gb():
        return {"allocated": torch.cuda.memory_allocated() / 1e9,
                "peak": torch.cuda.max_memory_allocated() / 1e9,
                "reserved": torch.cuda.memory_reserved() / 1e9}

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    api = zoo.build(cfg, Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.float32),
                    device="cuda")
    out = {}
    params = api.init_train(0)
    out["init"] = gb()
    opt = adamw.init_state(params)
    out["opt"] = gb()
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=2, seed=0), 0,
                     device="cuda")
    with train.deterministic() if det else contextlib.nullcontext():
        torch.cuda.reset_peak_memory_stats()
        _, grads = train.value_and_grad(api.loss_fn, params, batch)
        torch.cuda.synchronize()
        out["grad"] = gb()
        torch.cuda.reset_peak_memory_stats()
        adamw.apply_updates(params, grads, opt, adamw.AdamWConfig())
        torch.cuda.synchronize()
        out["update"] = gb()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    st = sub.add_parser("step")
    st.add_argument("--tree", default=ROOT)
    st.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help=f"of {', '.join(VARIANTS)} (default all)")
    me = sub.add_parser("memory")
    me.add_argument("arch")
    me.add_argument("layers", type=int)
    me.add_argument("--nondeterministic", action="store_true")
    me.add_argument("--expandable", action="store_true")
    args = ap.parse_args(argv)
    if args.what == "step" and not set(args.variants) <= set(VARIANTS):
        ap.error(f"variants are {', '.join(VARIANTS)}")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    tree = os.path.abspath(getattr(args, "tree", ROOT))
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_train_study: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.what == "step":
        out = {"tree": tree, **step_times(args.variants)}
    else:
        out = {"arch": args.arch, "layers": args.layers,
               **step_memory(args.arch, args.layers, not args.nondeterministic,
                             args.expandable)}
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
