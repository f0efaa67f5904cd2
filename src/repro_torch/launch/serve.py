"""Serving CLI of the port (counterpart of ``repro/launch/serve.py``).

Serves a batch of seeded random prompts from seeded random weights
(packed to W4 with ``--packed``), and prints throughput, the engine's
serving-core counters and the tokens.  ``--paged`` serves through the
engine of the family's page layout (``api.page_spec.layout``):
``PagedEngine`` over KV pages for the dense and MoE families,
``StatePagedEngine`` over ``state`` pages for the SSM, hybrid and enc-dec
families (``--arch mamba2_130m``, ``--arch recurrentgemma_9b``, ``--arch
whisper_base``; an enc-dec model's encoder output in ``shared_ro`` pages,
encoded once for the batch, whose requests all carry the same seeded stub
frames, ``_stub_frames``); with ``--paged`` a KV family's prompts also
go through ``launch.batching.ContinuousBatcher`` over the same model,
and the CLI prints whether the two engines' outputs agree.  The VLM
family (``--arch pixtral_12b``) has no paged path: ``--paged``,
``--chaos`` and ``--best-of`` > 1 raise ``zoo.UnsupportedModelError``.

Without ``--paged`` the batch is served contiguously (one batched
prefill, then decode steps over the model's contiguous caches): a KV
family or a VLM as the reference's CLI does — float weights, then W4A4
with fake-quantized weights and activations, then with ``--packed`` the
packed 4-bit weights through the fused W4A4 linear (``--unfused``: the
plain decode-and-matmul route), each with its token agreement against
the float run; a state family the one model (``--packed`` or float)
through ``generate_contiguous``.  The decode reads only the written
prefix of the cache, so the reference's ``--kv-bucket N`` is accepted
and changes nothing.  The packed forward needs every linear's input in
whole 64-wide arrays, as the reference's: Qwen2's smoke (d_model 112)
serves float and W4A4 only::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b --smoke \\
        --device cpu --packed

Admission is the
slab prefill unless ``--chunked-prefill`` (KV layout only); prefix caching is on unless
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

Telemetry, with the reference's flags (each implies ``--paged``):
``--metrics-json PATH`` dumps the engine's ``snapshot()`` (counters,
gauges, histograms, timelines), ``--trace-out PATH`` its tick journal as
Chrome-trace JSON (open it in Perfetto, ui.perfetto.dev, or
chrome://tracing), and ``--quant-probes`` attaches the LO-BCQ activation
quant-error probes (per-site, per-layer NMSE and codebook occupancy, in
the metrics dump) to the W4A4 model; ``tools/check_telemetry.py`` validates
the two files::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --paged \\
        --packed --chunked-prefill --quant-probes --metrics-json m.json --trace-out t.json \\
        && python tools/check_telemetry.py m.json t.json

``--chaos`` runs the reference's chaos smoke instead (``run_chaos``): the
W4A4 batch through a paged engine with every fault seam armed
(``serving/faults.py``), periodic audits, a bounded queue and two
submission waves; ``--chaos-report PATH`` writes the report that
``tools/check_chaos.py`` validates::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt3_126m --chaos \\
        --chaos-seed 0 --chaos-report chaos.json && python tools/check_chaos.py chaos.json

``--host-tier`` (with ``--host-pages N``, 256 by default) adds the host-RAM
page tier to a serving or chaos run: evicted parked prefix pages and
preemption victims' pages move to a bounded host pool and stream back
with their blake2b digest verified (a corrupt swap-in quarantines only
its owner); ``--recompress-after N`` arms the cold-page recompression
ladder (native → int8 → bcq4 value precision) after N pressured ticks.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.core.bcq import BCQConfig
from repro_torch.launch.batching import ContinuousBatcher
from repro_torch.models import zoo
from repro_torch.models.layers import Runtime
from repro_torch.serving.audit import audit_engine
from repro_torch.serving.engine import PagedEngine
from repro_torch.serving.faults import SITES, FaultInjector
from repro_torch.serving import prng
from repro_torch.serving.generate import (
    GREEDY,
    Request,
    SamplingParams,
    greedy_generate,
    next_greedy_tokens,
)
from repro_torch.serving.state_engine import StatePagedEngine
from repro_torch.serving.telemetry import QuantProbeRecorder, QuantProbeSink


def build_model(cfg, cache: str = "bcq4", packed: bool = True, device="cuda", seed: int = 0,
                kernels: bool = True, quant_probe=None, quant: str = None, fused: bool = None):
    """(api, params): seeded random weights (packed to W4 with ``packed``)
    on ``device``; ``kernels`` selects the fused linear, the page-gather
    kernel and the KV-page writer, else the plain paths; ``quant_probe``: a
    ``QuantProbeRecorder`` for the activation quant-error probes.
    ``quant`` names the quant mode instead of ``packed`` (``"fake"``: W4A4
    with fake-quantized weights and activations); ``fused`` False takes a
    packed weight's plain decode-and-matmul route with the kernels on."""
    rt = Runtime(
        quant_mode=quant or ("packed" if packed else "none"), bcq_cfg=BCQConfig(),
        compute_dtype=torch.float32, cache_kind=cache,
        paged_kernel=kernels, fused_linear=kernels if fused is None else fused,
        quant_probe=quant_probe,
    )
    api = zoo.build(cfg, rt, device=device)
    return api, api.init(seed)


def _stub_frames(cfg) -> np.ndarray:
    """The stub audio-frame embeddings of an enc-dec model (the conv
    frontend is a stub): (encoder_len, d_model) f32, normal · 0.02 from
    key 11 of ``serving/prng.py`` — the reference's
    ``jax.random.normal(PRNGKey(11), ...) * 0.02``.  One frame tensor for
    the whole batch, so the shared encoder page serves every request."""
    t, d = cfg.encoder_len, cfg.d_model
    return (prng.normal(prng.prng_key(11), t * d).reshape(t, d) * 0.02).numpy()


def generate_contiguous(api, cfg, params, prompts, frames, gen_len: int, max_len: int,
                        device="cuda"):
    """Contiguous greedy decoding of the prompt batch (B, S) for any servable
    family: ``greedy_generate`` unless the
    family conditions on ``frames`` (enc-dec: every row over the same
    frames, one batched prefill with the encoder, then ``gen_len - 1``
    decode steps).  Returns (B, gen_len) int32 tokens."""
    if frames is None:
        return greedy_generate(api, params, prompts, gen_len, max_len, device=device)
    device = zoo.resolve_device(device)
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(device)
    b, s = tokens.shape
    fr = torch.from_numpy(np.asarray(frames, np.float32)).to(device)[None].expand(
        (b,) + tuple(np.shape(frames)))
    logits, caches = api.prefill_fn(params, {"tokens": tokens, "frames": fr}, max_len)
    out = [next_greedy_tokens(logits)]
    for t in range(gen_len - 1):
        logits, caches = api.decode_fn(params, caches, out[-1][:, None], s + t)
        out.append(next_greedy_tokens(logits))
    return torch.stack(out, 1)


def is_state_layout(api) -> bool:
    """The family serves through StatePagedEngine (state pages)."""
    return api.page_spec is not None and api.page_spec.layout == "state_checkpoint"


def serve(cfg, prompts, gen: int, cache: str = "bcq4", packed: bool = True,
          page_size: int = 16, prefill_chunk: int = 0, device="cuda", seed: int = 0,
          kernels: bool = True, chunked_prefill: bool = False, prefix_caching: bool = True,
          best_of: int = 1, sampling: SamplingParams = GREEDY, pipeline_depth: int = 2,
          cuda_graphs=None, quant_probe=None, host_pages: int = 0, recompress_after: int = 0,
          frames=None, fused: bool = None):
    """Serve ``prompts`` (a list of 1-D token arrays) for ``gen`` tokens
    each (the prefill's token plus gen-1 decode tokens), ``best_of``
    forked siblings each, one slot per sibling.  ``seed`` draws the
    weights; ``kernels`` selects the fused linear, the page-gather kernel
    and the KV-page writer (``Runtime(fused_linear, paged_kernel)``); off,
    the plain decode+matmul, gather+softmax and encode+scatter paths run.
    ``pipeline_depth`` and ``cuda_graphs`` (None: on for a CUDA device)
    go to the engine, and ``host_pages`` (a host tier of that many pages
    if > 0) and ``recompress_after`` (the cold-page ladder if > 0);
    ``quant_probe`` (a ``QuantProbeRecorder``) to the model; ``frames``
    condition every request of an enc-dec model; ``fused`` as in
    ``build_model``.  Returns (finished requests, engine)."""
    api, params = build_model(cfg, cache, packed, device, seed, kernels, quant_probe,
                              fused=fused)
    max_len = -(-(max(len(p) for p in prompts) + gen + 1) // page_size) * page_size
    n_slots = len(prompts) * best_of
    if is_state_layout(api):
        if chunked_prefill or recompress_after:
            raise ValueError("chunked prefill and the recompression ladder are of the KV layout; "
                             "a state-checkpoint family prefills each prompt in one launch")
        eng = StatePagedEngine(
            api, params, n_slots=n_slots, max_len=max_len, page_size=page_size,
            prefix_caching=prefix_caching, pipeline_depth=pipeline_depth,
            cuda_graphs=cuda_graphs, device=device, host_pages=host_pages)
    else:
        eng = PagedEngine(
            api, params, n_slots=n_slots, max_len=max_len, page_size=page_size,
            prefix_caching=prefix_caching, chunked_prefill=chunked_prefill,
            prefill_chunk=prefill_chunk or 2 * page_size, pipeline_depth=pipeline_depth,
            cuda_graphs=cuda_graphs, device=device, host_pages=host_pages,
            recompress_after=recompress_after,
        )
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=gen - 1, n_samples=best_of,
                           sampling=sampling, frames=frames))
    finished, _ = eng.run_to_completion()
    return finished, eng


def run_chaos(api, params, prompts, gen: int, page_size: int = 16, prefill_chunk: int = 0,
              seed: int = 0, rate: float = 0.05, report_path=None, audit_every: int = 0,
              deadline_s=None, degrade_after=None, pipeline_depth: int = 2, cuda_graphs=None,
              arch: str = "gpt3_126m", cache: str = "bcq4", host_pages: int = 0,
              recompress_after: int = 0, frames=None) -> dict:
    """The chaos smoke (the reference's ``run_chaos``): ``prompts`` served
    twice over (two waves, the second queued behind the first; odd rids
    fork in 2) by an engine of one slot per prompt (a chunked-prefill
    PagedEngine, or a StatePagedEngine for a state-checkpoint family) with a
    ``FaultInjector`` at every site — ``rate`` for the transient sites,
    a fifth of it for ``logits`` and ``sampler`` (each roll kills a
    request) — an audit every ``audit_every`` ticks (4 if 0) and a queue
    bounded at twice the batch; ``host_pages`` > 0 adds the host tier
    (its swap seams armed at ``rate`` too) and ``recompress_after`` the
    ladder; ``frames`` condition every request of an enc-dec model.  The
    run must end with no exception escaping the engine, no page
    referenced and a clean audit.  Returns the report (the reference's
    schema 1, written to ``report_path`` if given)."""
    batch = len(prompts)
    rates = {s: (rate / 5 if s in ("logits", "sampler") else rate) for s in SITES}
    faults = FaultInjector(seed=seed, rates=rates)
    max_len = -(-(max(len(p) for p in prompts) + gen + 1) // page_size) * page_size
    common = dict(n_slots=batch, max_len=max_len, page_size=page_size, fault_injector=faults,
                  audit_every=audit_every or 4, max_queue=2 * batch, degrade_after=degrade_after,
                  pipeline_depth=pipeline_depth, cuda_graphs=cuda_graphs, device=api.device,
                  host_pages=host_pages)
    if is_state_layout(api):
        eng = StatePagedEngine(api, params, **common)
    else:
        eng = PagedEngine(api, params, chunked_prefill=True,
                          prefill_chunk=prefill_chunk or 2 * page_size,
                          recompress_after=recompress_after, **common)
    reqs = [Request(rid=wave * batch + i, prompt=prompts[i], max_new=gen - 1,
                    n_samples=2 if (wave * batch + i) % 2 else 1, deadline_s=deadline_s,
                    frames=frames)
            for wave in range(2) for i in range(batch)]
    unhandled, ticks = None, 0
    try:
        for r in reqs:
            eng.submit(r)
        _, ticks = eng.run_to_completion(max_ticks=10_000)
    except Exception as exc:  # what the containment must never let happen
        unhandled = f"{type(exc).__name__}: {exc}"
    audit = audit_engine(eng)
    leaked = int((eng.pool_mgr.refcount > 0).sum())
    outcomes = [{"rid": int(r.rid), "sample_idx": int(r.sample_idx),
                 "error_kind": None if r.error is None else getattr(r.error, "kind", None),
                 "n_out": len(r.out)} for r in eng.finished]
    report = {
        "schema": 1, "arch": arch, "cache": cache, "page_layout": eng.PAGE_LAYOUT,
        "host_tier": bool(host_pages), "host_pages": host_pages,
        "recompress_after": recompress_after, "chaos_seed": seed, "chaos_rate": rate,
        "deadline_s": deadline_s, "n_requests": len(reqs),
        "all_finished": {o["rid"] for o in outcomes} == {r.rid for r in reqs},
        "ticks": ticks, "unhandled_exception": unhandled, "leaked_pages": leaked,
        "pages_by_kind": eng.pool_mgr.used_by_kind(),  # live (allocated or parked) pages
        "final_audit": audit.to_dict(), "health": eng.health(), "faults": faults.summary(),
        "requests": outcomes,
    }
    errs: dict = {}
    for o in outcomes:
        if o["error_kind"]:
            errs[o["error_kind"]] = errs.get(o["error_kind"], 0) + 1
    print(f"chaos  : seed={seed} rate={rate} cache={cache} host_tier="
          f"{'on' if host_pages else 'off'} pipeline depth {eng.pipeline_depth} — "
          f"{len(outcomes)} finished over {ticks} ticks, {report['faults']['total']} faults "
          f"injected {report['faults']['by_site']}, errors {errs or '{}'}; leaked pages {leaked}, "
          f"audit {'clean' if audit.ok else 'DIRTY'}, unhandled {unhandled or 'none'}")
    if host_pages:
        sw = report["health"]["swap"]
        print(f"chaos  : swap outs={sw['swap_outs']} ins={sw['swap_ins']} (verified "
              f"{sw['verified_swapins']} / corrupt {sw['corrupt_swapins']}), skips="
              f"{sw['swap_skips']}, bytes={sw['swap_bytes']}, recompressed="
              f"{sw['recompressed_pages']}")
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"chaos  : report -> {report_path}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gpt3_126m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache", default="bcq4", choices=["bf16", "int8", "bcq4"])
    ap.add_argument("--paged", action="store_true",
                    help="serve via the paged engine of the family's page layout (else "
                         "contiguously)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="chunk-at-a-time admission (default: one slab prefill per prompt)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="do not share full prompt pages across requests")
    ap.add_argument("--packed", action="store_true", help="W4A4: packed 4-bit weights")
    ap.add_argument("--unfused", action="store_true",
                    help="with --packed: the plain decode-and-matmul route of the packed "
                         "weights instead of the fused W4A4 linear")
    ap.add_argument("--kv-bucket", type=int, default=0,
                    help="the reference CLI's bucketed cache read, accepted for its flags: "
                         "the port's contiguous decode reads only the written prefix, which "
                         "no bucket exceeds, so the tokens are the same")
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
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the paged engine's metrics snapshot (histograms / gauges / "
                         "timelines) as JSON; implies --paged")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the tick journal as Chrome-trace JSON (Perfetto / "
                         "chrome://tracing); implies --paged")
    ap.add_argument("--quant-probes", action="store_true",
                    help="attach online LO-BCQ activation-quant probes (per-layer/site NMSE + "
                         "codebook-cluster occupancy) to the W4A4 model; implies --paged")
    ap.add_argument("--chaos", action="store_true",
                    help="chaos smoke: serve the W4A4 batch through a paged engine with "
                         "seeded fault injection at every seam and periodic audits, then "
                         "report containment (validated by tools/check_chaos.py); runs "
                         "instead of the serving run and implies --paged")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault-injection seed: faults are a pure function of (seed, site, "
                         "tick, key), so a run replays bit for bit")
    ap.add_argument("--chaos-rate", type=float, default=0.05,
                    help="per-site fault probability per injection point")
    ap.add_argument("--chaos-report", default=None, metavar="PATH",
                    help="write the chaos report JSON (faults, health, final audit, outcomes)")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="run the page-ownership audit every N ticks (0: chaos mode's 4)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="chaos mode: each request's deadline in seconds (kind 'expired')")
    ap.add_argument("--degrade-after", type=int, default=None,
                    help="chaos mode: enter degraded mode after N ticks at the admission "
                         "watermark (default: off)")
    ap.add_argument("--host-tier", action="store_true",
                    help="the host-RAM page tier: evicted parked prefix pages and preemption "
                         "victims' pages move to a bounded host pool (blake2b-verified "
                         "swap-ins) instead of being recomputed")
    ap.add_argument("--host-pages", type=int, default=256,
                    help="host-tier capacity in pages (with --host-tier)")
    ap.add_argument("--recompress-after", type=int, default=0,
                    help="recompress cold parked pages (native->int8->bcq4) after N consecutive "
                         "ticks at or below the admission watermark (0 = off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.metrics_json or args.trace_out or args.quant_probes:
        args.paged = True
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    spec = zoo.page_spec(cfg)
    if (args.paged or args.chaos or args.best_of > 1) and spec is None:
        # the typed refusal before any compute (a VLM has no paged path)
        raise zoo.UnsupportedModelError(
            cfg.name, cfg.family,
            reason="Drop --paged/--chaos/--best-of or pick an arch from a servable family.")
    host_pages = args.host_pages if args.host_tier else 0
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (args.batch, args.prompt_len))
    frames = _stub_frames(cfg) if cfg.family == "encdec" else None
    if not (args.paged or args.chaos):
        if spec is not None and spec.layout == "state_checkpoint":
            return serve_contiguous(cfg, prompts, args.gen, args.packed, args.device, frames,
                                    unfused=args.unfused)
        if args.kv_bucket:
            print(f"kv bucket {args.kv_bucket}: the decode reads the written prefix, within "
                  f"every bucket (no bound needed)")
        return serve_contiguous_kv(cfg, prompts, args.gen, args.cache, args.packed,
                                   args.device, args.unfused)
    if args.chaos:  # W4A4 packed weights, as the reference's chaos smoke
        api, params = build_model(cfg, args.cache, True, args.device)
        rep = run_chaos(api, params, list(prompts), args.gen, args.page_size, args.prefill_chunk,
                        args.chaos_seed, args.chaos_rate, args.chaos_report, args.audit_every,
                        args.deadline_s, args.degrade_after, args.pipeline_depth,
                        arch=cfg.name, cache=args.cache, host_pages=host_pages,
                        recompress_after=args.recompress_after, frames=frames)
        return 0 if rep["unhandled_exception"] is None else 1
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k, seed=args.seed)
    probe_sink = QuantProbeSink(n_layers=cfg.n_layers) if args.quant_probes else None
    t0 = time.perf_counter()
    finished, eng = serve(
        cfg, list(prompts), args.gen, args.cache, args.packed, args.page_size, args.prefill_chunk,
        args.device, chunked_prefill=args.chunked_prefill,
        prefix_caching=not args.no_prefix_cache, best_of=args.best_of, sampling=sampling,
        pipeline_depth=args.pipeline_depth,
        quant_probe=None if probe_sink is None else QuantProbeRecorder(probe_sink),
        host_pages=host_pages, recompress_after=args.recompress_after, frames=frames,
        fused=False if args.unfused else None,
    )
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in finished)
    where = torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} device={where} cache={args.cache} packed={args.packed} "
          f"{toks} tokens in {dt:.3f}s ({toks / dt:.1f} tok/s incl. set-up) "
          f"decode ticks {eng.stats['decode_ticks']} prefill launches {eng.stats['prefill_launches']} "
          f"pipeline depth {eng.pipeline_depth} decode graphs {eng.trace_counts()['decode']}"
          + (f" linear route {_route(eng.api.rt)}" if args.packed else ""))
    if eng.PAGE_LAYOUT == "kv" and args.best_of == 1:
        compare_batcher(eng, list(prompts), finished, args.gen, sampling)
    keys = ("prefix_hits", "prefix_misses", "prefill_tokens_skipped", "forks", "shared_pages",
            "cow_copies", "preemptions", "prefix_evictions")
    print(f"serving core ({eng.PAGE_LAYOUT} pages): "
          + ", ".join(f"{k} {eng.stats[k]}" for k in keys))
    if eng.PAGE_LAYOUT == "state":
        print("state pages: " + ", ".join(f"{k} {v}" for k, v in
                                          eng.health()["state_counters"].items()))
    if host_pages:
        print("host tier: " + ", ".join(f"{k} {v}" for k, v in eng.health()["swap"].items())
              + f"; prefix host hits {eng.prefix.host_hits}")
    for r in sorted(finished, key=lambda r: (r.rid, r.sample_idx)):
        print(f"  rid {r.rid} sample {r.sample_idx}: {r.out}")
    if args.metrics_json or args.trace_out or args.quant_probes:
        report_telemetry(eng, args.metrics_json, args.trace_out, probe_sink)


def _route(rt) -> str:
    """The linear route a packed model takes, as the CLI prints it."""
    return "fused W4A4 linear kernel" if rt.fused_linear else "decode + matmul (--unfused)"


def compare_batcher(eng, prompts, finished, gen: int, sampling: SamplingParams) -> bool:
    """``prompts``, which ``eng`` served for ``gen`` tokens each, again
    through ``ContinuousBatcher`` over the same model (one slot a request,
    per-request prefill); prints whether the two engines' outputs are
    equal, and returns it."""
    t0 = time.perf_counter()
    cbat = ContinuousBatcher(eng.api, eng.params, n_slots=len(prompts), max_len=eng.max_len)
    for i, p in enumerate(prompts):
        cbat.submit(Request(rid=i, prompt=p, max_new=gen - 1, sampling=sampling))
    fin_c, _ = cbat.run_to_completion()
    dt = time.perf_counter() - t0
    got = {r.rid: r.out for r in fin_c}
    equal = sum(r.out == got.get(r.rid) for r in finished)
    match = equal == len(prompts)
    print(f"contig : {sum(len(o) for o in got.values())} tokens in {dt:.3f}s "
          f"(slot-contiguous engine, {cbat.launches} launches); paged outputs "
          f"{'==' if match else '!='} contiguous engine ({equal} of {len(prompts)} requests "
          f"equal)")
    return match


def serve_contiguous_kv(cfg, prompts, gen: int, cache: str, packed: bool, device,
                        unfused: bool = False) -> int:
    """The reference CLI's contiguous comparison for a transformer family:
    the prompt batch (B, S) through ``greedy_generate`` with float weights,
    with W4A4 fake-quantized weights and activations, and with ``packed``
    the packed 4-bit weights too (the fused
    W4A4 linear, or its plain decode-and-matmul route with ``unfused``).
    Prints each run's rate and token agreement with the float run."""
    max_len = prompts.shape[1] + gen + 1
    modes = [("float", "none", None), ("W4A4", "fake", None)]
    if packed:
        modes.append(("packed", "packed", False if unfused else None))
    ref = None
    for label, quant, fused in modes:
        api, params = build_model(cfg, cache, device=device, quant=quant, fused=fused)
        t0 = time.perf_counter()
        out = greedy_generate(api, params, prompts, gen, max_len, device=device)
        if api.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref = out if ref is None else ref
        where = torch.cuda.get_device_name(api.device) if api.device.type == "cuda" else "cpu"
        what = {"float": "float weights",
                "W4A4": "fake-quant weights and activations",
                "packed": f"4-bit weight buffers, {_route(api.rt)}"}[label]
        print(f"{label:7s}: arch={cfg.name} device={where} cache={cache} contiguous: "
              f"{out.numel()} tokens in {dt:.3f}s ({out.numel() / dt:.1f} tok/s; {what}) "
              f"agreement vs float {(out == ref).float().mean().item() * 100:.1f}%")
        for i, row in enumerate(out.tolist()):
            print(f"  rid {i}: {row}")
        del api, params
    return 0


def serve_contiguous(cfg, prompts, gen: int, packed: bool, device, frames=None,
                     unfused: bool = False) -> int:
    """The contiguous path of a state family: the prompt batch (B, S)
    through ``generate_contiguous`` (one batched prefill, then ``gen - 1``
    decode steps over the model's caches).  Prints the tokens and the
    rate."""
    api, params = build_model(cfg, packed=packed, device=device,
                              fused=False if unfused else None)
    t0 = time.perf_counter()
    out = generate_contiguous(api, cfg, params, prompts, frames, gen, prompts.shape[1] + gen,
                              device=device)
    if api.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(api.device) if api.device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} device={where} packed={packed} contiguous: {out.numel()} tokens in "
          f"{dt:.3f}s ({out.numel() / dt:.1f} tok/s)")
    for i, row in enumerate(out.tolist()):
        print(f"  rid {i}: {row}")
    return 0


def report_telemetry(eng, metrics_json=None, trace_out=None, probe_sink=None):
    """The reference CLI's telemetry epilogue: write the metrics snapshot
    (with the probe report) and the Chrome trace where asked, and print
    the latency histograms' means and the probes' worst sites."""
    tel = eng.telemetry
    if metrics_json:
        tel.dump_metrics(metrics_json, engine=eng, probe_sink=probe_sink)
        print(f"telemetry: metrics snapshot -> {metrics_json}")
    if trace_out:
        tel.dump_trace(trace_out)
        print(f"telemetry: Chrome trace ({len(tel.journal)} events, {tel.journal.dropped} "
              f"dropped) -> {trace_out}")
    hs = tel.registry.snapshot()["histograms"]
    ttft, itl, qt = hs["ttft_s"], hs["itl_s"], hs["queue_time_s"]
    print(f"telemetry: ttft mean {ttft['mean'] * 1e3:.2f} ms (n={ttft['count']}), itl mean "
          f"{itl['mean'] * 1e3:.2f} ms (n={itl['count']}), queue mean {qt['mean'] * 1e3:.2f} ms "
          f"(n={qt['count']})")
    if probe_sink is not None:
        rep = probe_sink.report()
        worst = sorted(((d["nmse_mean"], site, layer) for site, per in rep["sites"].items()
                        for layer, d in per.items()), reverse=True)[:3]
        print(f"quant-probes: {rep['emissions']} emissions over {len(rep['sites'])} sites × "
              f"{rep['n_layers']} layers; worst NMSE: "
              + ", ".join(f"{s}/L{la}={m:.2e}" for m, s, la in worst))


if __name__ == "__main__":
    raise SystemExit(main())
