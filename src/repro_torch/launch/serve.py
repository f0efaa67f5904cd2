"""Serving CLI of the port (counterpart of ``repro/launch/serve.py``).

Serves a batch of seeded random prompts through ``PagedEngine`` from
seeded random weights (packed to W4 with ``--packed``), and prints
throughput, the engine's serving-core counters and the tokens.  Only the
paged engine is ported, so ``--paged`` is required.  Admission is the
slab prefill unless ``--chunked-prefill``; prefix caching is on unless
``--no-prefix-cache``; ``--best-of N`` forks every prompt into N siblings
sharing its pages, and ``--temperature`` / ``--top-k`` / ``--seed`` turn
on seeded sampling (deterministic per seed, sample index and position).
The engine runs the pipelined tick at ``--pipeline-depth`` (2 by
default, as the reference's CLI: launch tick t, then sync tick t−1).
Runs on the card by default (``--device cuda``), where each decode tick
is one CUDA graph replay per block-table width; ``--device cpu`` runs
the plain versions eagerly::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt3_126m \\
        --paged --chunked-prefill --packed --cache bcq4 --batch 8 --gen 32 \\
        --best-of 2 --temperature 0.8 --top-k 40 --seed 1234 --pipeline-depth 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.core.bcq import BCQConfig
from repro_torch.models import zoo
from repro_torch.models.layers import Runtime
from repro_torch.serving.engine import PagedEngine
from repro_torch.serving.generate import GREEDY, Request, SamplingParams


def serve(cfg, prompts, gen: int, cache: str = "bcq4", packed: bool = True,
          page_size: int = 16, prefill_chunk: int = 0, device="cuda", seed: int = 0,
          kernels: bool = True, chunked_prefill: bool = False, prefix_caching: bool = True,
          best_of: int = 1, sampling: SamplingParams = GREEDY, pipeline_depth: int = 2,
          cuda_graphs=None):
    """Serve ``prompts`` (a list of 1-D token arrays) for ``gen`` tokens
    each (the prefill's token plus gen-1 decode tokens), ``best_of``
    forked siblings each, one slot per sibling.  ``seed`` draws the
    weights; ``kernels`` selects the fused linear, the page-gather kernel
    and the KV-page writer (``Runtime(fused_linear, paged_kernel)``); off,
    the plain decode+matmul, gather+softmax and encode+scatter paths run.
    ``pipeline_depth`` and ``cuda_graphs`` (None: on for a CUDA device)
    go to the engine.  Returns (finished requests, engine)."""
    rt = Runtime(
        quant_mode="packed" if packed else "none", bcq_cfg=BCQConfig(),
        compute_dtype=torch.float32, cache_kind=cache,
        paged_kernel=kernels, fused_linear=kernels,
    )
    api = zoo.build(cfg, rt, device=device)
    params = api.init(seed)
    max_len = -(-(max(len(p) for p in prompts) + gen + 1) // page_size) * page_size
    eng = PagedEngine(
        api, params, n_slots=len(prompts) * best_of, max_len=max_len, page_size=page_size,
        prefix_caching=prefix_caching, chunked_prefill=chunked_prefill,
        prefill_chunk=prefill_chunk or 2 * page_size, pipeline_depth=pipeline_depth,
        cuda_graphs=cuda_graphs, device=device,
    )
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=gen - 1, n_samples=best_of,
                           sampling=sampling))
    finished, _ = eng.run_to_completion()
    return finished, eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gpt3_126m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache", default="bcq4", choices=["bf16", "int8", "bcq4"])
    ap.add_argument("--paged", action="store_true", help="serve via the paged engine (required)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="chunk-at-a-time admission (default: one slab prefill per prompt)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="do not share full prompt pages across requests")
    ap.add_argument("--packed", action="store_true", help="W4A4: packed 4-bit weights")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0, help="0 → 2 × page size")
    ap.add_argument("--best-of", type=int, default=1,
                    help="fork every prompt into N siblings sharing its pages")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="seeded sampling temperature (0 = exact greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the top-k logits only (0 = full vocabulary)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed: tokens are deterministic per (seed, sample index, "
                         "position)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="decode launches in flight (1: sync each tick before the next)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.paged:
        ap.error("the port serves the paged engine only: pass --paged")
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (args.batch, args.prompt_len))
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k, seed=args.seed)
    t0 = time.perf_counter()
    finished, eng = serve(
        cfg, list(prompts), args.gen, args.cache, args.packed, args.page_size, args.prefill_chunk,
        args.device, chunked_prefill=args.chunked_prefill,
        prefix_caching=not args.no_prefix_cache, best_of=args.best_of, sampling=sampling,
        pipeline_depth=args.pipeline_depth,
    )
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in finished)
    where = torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} device={where} cache={args.cache} packed={args.packed} "
          f"{toks} tokens in {dt:.3f}s ({toks / dt:.1f} tok/s incl. set-up) "
          f"decode ticks {eng.stats['decode_ticks']} prefill launches {eng.stats['prefill_launches']} "
          f"pipeline depth {eng.pipeline_depth} decode graphs {eng.trace_counts()['decode']}")
    keys = ("prefix_hits", "prefix_misses", "prefill_tokens_skipped", "forks", "shared_pages",
            "cow_copies", "preemptions", "prefix_evictions")
    print("serving core: " + ", ".join(f"{k} {eng.stats[k]}" for k in keys))
    for r in sorted(finished, key=lambda r: (r.rid, r.sample_idx)):
        print(f"  rid {r.rid} sample {r.sample_idx}: {r.out}")


if __name__ == "__main__":
    main()
