#!/usr/bin/env python3
"""The spread of ``chip_smoke.py`` phase 24's logits noise floor, on one
NVIDIA GPU; not part of the smoke:

    python3 chip_floor_study.py CKPT [quantize CLI flags, e.g. --n-codebooks 16]
        [--layers 12,4,2,1] [--seeds 7,8,9,10,11]

CKPT is a train-CLI checkpoint (phase 21's: ``python -m
repro_torch.launch.train --arch gpt3_126m --batch 4 --seq 2048 --steps 200
--warmup 20 --lr 0.001 --save-every 201 --ckpt CKPT``).  It is quantized
by the CLI at the format the flags give (under the ignored
``build/floor_study/``), and the packed artifact's first N layers (each of
``--layers``) answer phase 24's workload through ``_forward_logits``: the
kernel path (B1, B2, the page writer) against the plain path, and the
plain path against itself with every linear moved by B1's tolerance
(``b1_tolerance_noise``) under each seed — phase 24 holds the kernel path
to seed 7's draw alone.  Prints each comparison.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT = os.path.join(ROOT, "build", "floor_study")


def _first(tree, n):
    return {k: _first(v, n) for k, v in tree.items()} if isinstance(tree, dict) else tree[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("--layers", default="12,4,2,1")
    ap.add_argument("--seeds", default="7,8,9,10,11")
    args, flags = ap.parse_known_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_floor_study: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.checkpoint.manager import load_pytree
    from repro_torch.configs.base import get_arch
    from repro_torch.core import ptq
    from repro_torch.core.bcq import BCQConfig
    from repro_torch.launch import quantize
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(OUT, ignore_errors=True)
    manifest = quantize.main(["--ckpt", args.ckpt, "--out", OUT, *flags])

    def to_cuda(t):
        return {k: to_cuda(v) for k, v in t.items()} if isinstance(t, dict) else t.to("cuda")

    fake = to_cuda(load_pytree(os.path.join(OUT, "weights_w4_fake.npz")))
    full = ptq.packed_from_artifact(
        fake, to_cuda(load_pytree(os.path.join(OUT, "weights_w4_packed.npz"))))
    bcfg = BCQConfig(array_len=manifest["bcq"]["L_A"], n_codebooks=manifest["bcq"]["N_c"])
    base = get_arch("gpt3_126m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, base.vocab, n) for n in cs.PROMPT_LENS]
    print(f"{torch.cuda.get_device_name(0)}; {' '.join(flags)} ({bcfg.tag()})", flush=True)
    for n in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(base, n_layers=n)
        params = dict(full, layers=_first(full["layers"], n))
        rt = Runtime(quant_mode="packed", bcq_cfg=bcfg, compute_dtype=torch.float32,
                     cache_kind="bcq4", paged_kernel=True)
        api_k = zoo.build(cfg, rt, device="cuda")
        api_p = zoo.build(cfg, dataclasses.replace(rt, paged_kernel=False, fused_linear=False),
                          device="cuda")
        first = cs._forward_logits(api_p, params, prompts, [0] * len(prompts))
        tokens = [int(t) for t in first[:, 0].argmax(-1).cpu()]  # the greedy first tokens
        plain = cs._forward_logits(api_p, params, prompts, tokens)
        cs._compare(f"L{n} kernels vs plain", cs._forward_logits(api_k, params, prompts, tokens),
                    plain)
        for seed in (int(x) for x in args.seeds.split(",")):
            with cs.b1_tolerance_noise(seed):
                moved = cs._forward_logits(api_p, params, prompts, tokens)
            cs._compare(f"L{n} floor seed {seed}", moved, plain)
    return 0


if __name__ == "__main__":
    sys.exit(main())
