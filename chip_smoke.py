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
   without W4A4, with it to the plain path's own noise floor at B1's
   held tolerance: every plain linear's output moved by LINEAR_TOL);
   greedy tokens must agree under the margin rule (the logit tolerance:
   the plain path's change under a 1-ulp embedding scale); then one steady
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
    engine none; a steady greedy graph tick makes one graph replay and
    no eager kernel launch from the host (``_host_launches``: the graphs'
    replay counter and a dispatch-mode record of the aten ops on CUDA
    tensors, which need no profiler event; phases 13–15 and 18–20 check
    their steady ticks the same way).  For each way: wall
    ms/tick of steady ticks (8 rows), device busy, idle share and CUDA
    kernels a tick (torch.profiler over 3 ticks; "not measured" where it
    saw no device event); for phase 11's workload the same over its decode-only
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
    (graph nodes, one graph replay, no eager kernel launch) and
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
    bits and ``device_syncs``, 1 graph replay and no eager kernel
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
    graph replay, no eager kernel launch).  On a bf16 pool at full
    width, every page the ladder recompresses equals the CPU's
    ``_fake_quant`` of its bytes.  The resumed request's re-admission time
    beside its recompute in phase 12's tier-off run; one page's swap
    timed on an idle stream beside the copy's bound at 64 GB/s.  Its
    kernel runs' launches join the ``kernels`` line (``host_tier``).
16. the MoE family: full-width Moonlight-16B-A3B (``moonshot_v1_16b``:
    d 2048, 16 heads of 128, 64 experts top-6 of d_ff 1408, vocab 163840;
    2 of its 48 layers, a depth cut for the script's time; seeded random
    weights drawn and packed to W4 one layer at a time on the card, ~1.4
    GB of packed experts) with phase 4's settings and requests: the stacked fused
    linear (one launch for a layer's 64 experts of wi, wg or wo) bit for
    bit equal to its per-expert launches and held to its plain version at
    decode, chunk and ragged shapes; the production tick (graph depth 2)
    and eager depth 1 equal bit for bit; launches exactly 3 × 4 stacked
    B1, 4 × 4 dense B1, 4 B2 and 4 writer launches a pass; every launch
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
21. (run before 17) training: full-width gpt3_126m through
    ``python -m repro_torch.launch.train``'s ``main`` on the card, bf16
    compute on f32 parameters, 4 × 2048 tokens a step, 200 steps: the
    held-out loss (4 eval batches) falls by more than 0.5 nat
    (``tests/test_system.py``'s bar) and no kernel is launched (the float
    step is plain: no kernel of the reference has a backward); ms/step,
    tokens/s, the device idle share and the cost of the deterministic
    algorithms (windows on, off, off, on); an 8-step run of 1 × 2048
    tokens a step in a subprocess, started with the phase, sent SIGTERM
    after step 4 writes its snapshot and keeps running (it is
    killed once the snapshot lands), and the rerun resumes from it and ends
    bit-equal in every leaf to an uninterrupted run; 2 ``--quant fake``
    steps from the trained weights through the CLI, every B3 launch held
    to ``quantize_ref`` on its own inputs, exactly 4 a layer and pass, all
    but the first step's the threshold search (the trained books are no
    longer integers); one fake step's loss and every gradient leaf
    through B3's route equal to the plain route's (a codebook tie may move
    the codebook gradient: counted); B3's threshold search timed at (8192,
    768); the attention knobs on the trained state (``train_attention``):
    one train step with bf16 scores (``Runtime(attn_f32=False)``) against
    f32 in turns — ms/step, peak memory, |Δloss| within 1e-2 nat — and one
    held-out evaluation forward at query chunks of 256 and 2,048: the
    memory each adds, its logits held to the one-chunk run's.  Its B3
    launches join the ``kernels`` line (``training``; B3's entry gains
    ``trained_books``).
17. the PTQ deploy step on full-width gpt3_126m trained by phase 21: its
    weights saved again by the port's ``CheckpointManager`` (async writer)
    and restored bit for bit; ``python -m repro_torch.launch.quantize``'s
    ``main`` on the card over phase 21's checkpoint (calibration on one
    batch of 4 × 128 tokens, 15 LO-BCQ
    iterations; ``codebooks.json``, the fake and packed npz, the
    manifest; its 6 B3 launches of ``quantize_params``, held to the plain
    encode in a second run); the fit twice, byte-equal to each other and
    to the CLI's books, its history non-increasing, its books equal to the
    port's CPU fit of the same samples; the held-out loss of phase 9's
    batches (bf16, flash kernel) for the float weights, the fake artifact
    under every act_format, ``fake_full`` and the packed artifact, the
    W4A4 perplexity below 1.10 × the float one and below the int4
    activations' (``tests/test_system.py::test_ptq_pipeline_ppl_close``), launch counts
    per forward, every B3 launch of a fake and a fake_full forward and
    every B1 / B5 launch of a packed forward held to plain; both artifacts
    served on phase 4's settings and prompts, graph depth 2 ≡ eager depth
    1 bit for bit, exact launches a pass (fake: 4 B3, B2, writer a layer;
    packed: 6 B1, B2, writer), every launch of a prefill and a steady tick
    held to plain; B3's fake-quant form timed.  Its launches join the
    ``kernels`` line (``ptq``; B3's as ``ptq_fake_quant``).
18. the state-checkpoint layout: full-width Mamba2-130m (8 of its 24
    layers, a depth cut for the script's time; d 768, d_state 128; seeded
    random weights packed to W4, f32 compute)
    served in W4A4 through StatePagedEngine on phase 4's settings and
    prompts: graph depth 2 ≡ eager depth 1 bit for bit (tokens, margins,
    launch indices, counters, live tree and state pool bytes, B1 launches
    2 a layer and pass), every B1 launch of a first step (8 exact-length
    prefills), a steady tick and a checkpoint tick held to plain, kernel
    vs plain logits at 2 layers of the same width (where the noise floor
    is small); request 7 preempted and resumed from its checkpoint (≤ 16
    tokens replayed; tokens equal to the never-preempted run at
    ``quant_mode="none"``; at ``packed`` every B1 launch of the run, the
    batch-1 replay's too, held to plain, the flips against the
    never-preempted run printed) and from the host tier (no replay,
    bit-exact at both); greedy and sampled forks; the chaos smoke through
    ``tools/check_chaos.py``.
    Prints the steady tick, the checkpoint's extra device time, prefill
    tok/s, a state page's swap, resume vs recompute, and B1's times at the
    in_proj shape (N 3352).  Its launches join the ``kernels`` line
    (``state``).
19. the hybrid family: full-width RecurrentGemma-9B (5 of its 38
    layers, a depth cut for the script's time: 1 period of two RG-LRU
    blocks and a local-attention block + 2 tail RG-LRU blocks, where the
    model has 12 periods; d 4096, 16 heads of 256 and one KV head, d_ff 12288,
    window 2048, vocab 256000; seeded random weights drawn and packed to
    W4 a period at a time on the card, a bcq4 window ring, f32 compute)
    served in W4A4 through StatePagedEngine on (a) phase 4's settings and
    prompts and (b) two requests of 2,040 and 2,100 tokens for 40 tokens
    each: graph depth 2 ≡ eager depth 1 bit for bit on both, B1 launches
    34 a decode pass and 36 a prefill pass (254 and 278 at 38 layers);
    every B1 launch of (a)'s first step, a steady and a checkpoint tick and
    (b)'s first step (its prefills at M 2,040 and 2,100) held to plain;
    kernels vs plain logits of one RG-LRU block at the full width (one
    local-attention block, 2 layers and the 5-layer stack, 1 period + 2
    tail blocks, printed: there W4A4 flips swamp the comparison); request
    7 preempted after 20 ticks and resumed from its checkpoint (every
    replay launch held at ``packed``; tokens equal at
    ``quant_mode="none"``, flips counted at ``packed``) and from the host
    tier (no replay, bit-exact at both); greedy and sampled forks; the
    reference CI's hot state-layout chaos run (seed 3, rate 0.2, an audit
    every tick) through ``tools/check_chaos.py``.  Prints the init's
    seconds and resident GB, the steady tick, the checkpoint's extra
    device time, prefill tok/s, a state page's swap, resume vs recompute,
    and B1's times at the 12288 → 4096 shape (M 8 and 2,100).  Its
    launches join the ``kernels`` line (``hybrid``).
20. the enc-dec family: full-width Whisper-base (6 encoder and 6
    decoder layers, d 512, 8 heads of 64, d_ff 2048, 1,500 stub frames,
    vocab 51865; seeded weights packed to W4, a bcq4 decoder self cache,
    max_len 448) served in W4A4 through StatePagedEngine with its
    encoder output in shared_ro pages: 12 requests over 3 clips (decoder
    prompts of 4–224 tokens, 48 tokens each, 8 slots, page 16) — 3
    encodes and 9 prefix hits each skipping 1,500 frames; graph depth 2 ≡
    eager depth 1 bit for bit (the encoder pool too), B1 launched 48 an
    encode and 48 a decoder pass; every B1 launch of the first step, a
    steady and a checkpoint tick held to plain; request 7 preempted
    after 20 ticks and resumed from its checkpoint (every replay launch
    held, no encode) and from the host tier (bit-exact); a best-of-2
    fork sharing the encoder page; the hot chaos run; one encoder block
    and one decoder block kernels vs plain, held launch by launch up to
    the first W4A4 flip (the 6 + 6-layer logits printed); the evaluation
    forward (4 clips × 448 tokens, bf16) through B5 at (32, 448, 64), 6 B5
    and 96 B1 launches held to plain.  Prints
    the steady tick, graph nodes, B1's device ms a tick, an encode's ms,
    prefill tok/s on a hit, the resume ms, resident GB, and B1 and B5 at
    the whisper shapes.  Its launches join the ``kernels`` line
    (``encdec``; B5's ``encdec_eval``).
22. the rest of the model zoo: Qwen2-0.5B (GQA 14/2, qkv bias, tied),
    StarCoder2-3B (GQA 24/2, GELU, layernorm), Phi-3-medium-14B (GQA
    40/10, d_head 128) and Qwen1.5-32B (MHA 40, d_ff 27392) at full width,
    their depths cut for the script's time (``ZOO_LAYERS``: 6 of 24, 8 of
    30, 10 of 40, 8 of 64), one after the other, each drawn and packed to W4 a
    layer at a time on the card (bcq4 pool, f32 compute; init seconds and
    resident GB printed) and served phase 4's workload through
    PagedEngine at graph depth 2: launch counts exact (B1 7 a layer and
    pass under SwiGLU, 6 under GELU; B2 and the writer 1), the steady
    tick's wall, busy ms and graph nodes; every B1, B2 and writer launch
    of the last layer in the first engine step and a steady tick held to
    plain; the prompts again through ``ContinuousBatcher`` for 4 tokens
    each (agreement with the engine printed).  Then Pixtral-12B (vlm,
    32 heads of 128 over d 5120, 8 KV heads) contiguously: 4 prompts of
    320 tokens with 256 seeded stub patch embeddings written over their
    first positions, 16 greedy tokens, every B1 launch of the last layer
    held to plain.  Then the zoo's new shapes timed: B1 at (8, 896 →
    128), (8, 3072 → 256), (512, 5120 → 27392), B2 at each GQA config's
    decode and 64-token chunk, the writer at 2, 10 and 40 KV heads.  Its
    launches join the ``kernels`` line (``dense_zoo``; B1's ``vlm``).
23. the multi-device layer on one card: a one-rank NCCL group and
    ``derive_mesh()`` = (1, 1); at phase 21's settings 3 mesh train steps
    bit-equal to 3 plain steps in every leaf with 0 collective bytes,
    both timed in turns; 2 ``--quant fake`` mesh steps, every B3 launch
    held to plain; 5 compressed data-parallel steps over NCCL and one
    step's compressed all-reduce held to the same function on the CPU;
    the sequence-sharded decode within 1e-5 of the gathered one; the
    five kernels' meta branches at phase 10's shapes against the real
    launches and the script's bound arithmetic; the roofline of phase
    21's step against its measured time; one production dry-run cell in
    a subprocess.  B3's launches join the ``kernels`` line (``mesh``).
24. every LO-BCQ format on the card: (1) ``bcq.fake_quant`` at the
    paper's 25 formats (Table 8's L_b × L_A × N_c ablation, Table 5's
    W3/W2, Table 10's INT4/INT6/INT8 codewords, g128/N_c 16, g32/L_b 4,
    g16/L_b 2; codebooks fitted on the card) on Table 8's (256, 4096)
    operand, bit for bit against ``fake_quant_plain``, each NMSE equal to
    the CPU plain route's; (2) B1 (M 8, 512 × 768 → 3072), B1s (E 4 × C
    64), B4 (512 × 768 → 3072), the page writer and B2 at decode and a
    64-token chunk, at 7 formats (the reference kernel tests' 5, g128 at
    INT8 and at 8 entries), each held to plain, B1s ≡ per-expert B1 and
    B4 ≡ B1, timed beside the bound of its format's cost and, for B1, B1s
    and B4, one bf16 PyTorch call of the same product; (2′) B1, B1s and B4
    at a K of whole arrays but not of 64 (112 and 80 at L_A 16, 96 at L_A
    32: padded with zero arrays by the wrappers), held the same way, their
    launches counted exactly; (3) phase 21's
    checkpoint through the quantize CLI at ``--n-codebooks 16`` and
    ``--array-len 32 --n-codebooks 4``, each packed artifact served on
    phase 4's workload with bcq4 pages in its format: kernels (graph
    depth 2, launch counts exact) vs plain under the margin rule at the
    noise floor, the last layer's launches held to plain, the held-out
    W4A4 loss printed beside phase 17's.  Its launches join the
    ``kernels`` line (``formats``), with a ``formats`` entry per kernel.
25. the three examples (``examples/torch_*.py``) run in this process on
    the card at reduced steps; the quickstart's kernel results equal its
    plain ones.
26. the four families' training at full width (``FAM_TRAIN``):
    Moonlight-16B-A3B at 2 of its 48 layers, Mamba2-130m and Whisper-base
    whole (Whisper's 448-token decoder over the 1,500 stub frames),
    RecurrentGemma-9B at one period (3 of 38), 2 × 512 tokens a step, one
    family at a time through the train CLI's ``make_train_step`` (bf16
    compute on f32 params, the deterministic algorithms on): 3 float
    steps (step 1 run twice from the same state and equal bit for bit,
    every loss and grad norm finite, no kernel launched), then one
    ``--quant fake`` step from that state, B3 launched exactly once a
    quantized linear input, its loss and gradients through B3's route
    equal to the plain route's.  Prints ms/step, tokens/s and peak memory
    a family; B3's launches join the ``kernels`` line
    (``family_training``).
    Then the ``kernels`` JSON line
    (launches, error, times, bound), the card's name and power limit, and
    the device line as the last line.

Needs the repository's ``src/`` beside it: run alone, it fails.
"""
from __future__ import annotations

import contextlib
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
def linear_case(m, k, n, seed, cb, cfg=None):
    """Seeded activation (with a few outlier channels) and packed weight,
    in the format ``cfg`` (default ``BCQConfig()``)."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    x[:, :: max(1, k // 8)] *= 12.0
    w = torch.randn((n, k), generator=g) * k**-0.5
    enc = bcq.encode(w.cuda(), cb, cfg or bcq.BCQConfig())
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
def gather_pool(kind, n_pages, ps, hkv, d, seed, cb, cfg=None):
    """A single-layer page pool with every page written from seeded K/V
    (bcq4 in the format ``cfg``, default ``BCQConfig()``)."""
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.models import layers

    cfg = cfg or BCQConfig()
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
    print(f"greedy tokens kernels vs plain (margin rule, logit tol {tol:.3e} = the 1-ulp "
          f"scale's change): {agree}; plain-run top-2 margins min {margins.min():.4f} "
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


def _pool_diff(got: dict, want: dict, cb, cfg=None) -> int:
    """Differing bytes of two single-layer bcq4 pools in the format ``cfg``
    (default ``BCQConfig()``), or -1 where they disagree: the scale bytes
    must be equal, idx/sel bytes may differ only on a codebook tie (equal
    decoded values)."""
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.models.layers import cache_read

    n = sum(int((got[k] != want[k]).sum()) for k in got if got[k].ndim >= 2)
    if n == 0:
        return 0
    if not all(torch.equal(got[f"{s}_scale"], want[f"{s}_scale"]) for s in "kv"):
        return -1
    a, b = (cache_read(p, "bcq4", cfg or BCQConfig(), cb, torch.float32) for p in (got, want))
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


@contextlib.contextmanager
def b1_tolerance_noise(seed: int = 7):
    """Within the block, every plain linear's output (``layers.qdense``, the
    MoE expert matmul) is moved by B1's relative tolerance ``LINEAR_TOL``,
    up or down by a seeded coin per element: the error each B1 launch is
    allowed against its plain version, laid where B1 makes it."""
    import torch

    from repro_torch.models import layers, moe

    g = torch.Generator(device="cuda").manual_seed(seed)

    def moved(real):
        def run(*a, **kw):
            y = real(*a, **kw)
            u = torch.randint(0, 2, y.shape, generator=g, device=y.device).to(y.dtype) * 2 - 1
            return y * (1 + LINEAR_TOL * u)
        return run

    real = layers.qdense, moe._expert_matmul
    layers.qdense, moe._expert_matmul = moved(real[0]), moved(real[1])
    try:
        yield
    finally:
        layers.qdense, moe._expert_matmul = real


def phase_logits(eng_k, eng_p, prompts, tokens, float_check=True, margin="ulp"):
    """End-to-end logits of the kernel path against the plain path on
    identical inputs at full width, held to two yardsticks:

    * without W4A4 (float weights, bf16 pages — only the page-gather
      kernel differs) they must agree to rounding: max|Δ| ≤ 1e-3 ·
      max|logit| (f32 summation order, and a K/V value at a bf16 rounding
      boundary moving by one bf16 ulp, 2^-8, in the next layer's page);
    * with W4A4 the paths round differently and the 4-bit encode turns a
      last-bit difference into a quantization step wherever an activation
      sits at a threshold, so they agree to quantization noise.  The noise
      floor is the plain path against itself with every linear's output
      moved by B1's held relative tolerance (``b1_tolerance_noise``): what
      the rounding each B1 launch is allowed does through the encodes
      downstream; the kernel path may differ from the plain path by at
      most that (max and rms).  (A 1-ulp scale of the embedding, the
      earlier floor, is divided out by the first norm: on 5 of 10
      gpt3_126m draws it read rounding noise, ~1e-7, with no encode moved.)

    Returns the plain path's max|Δ| under a 1-ulp embedding scale (1 +
    2^-22): the margin rule's tolerance; with ``margin="floor"`` the noise
    floor's max|Δ| instead (phase 24: on trained weights a 1-ulp scale
    moves the logits by ~1e-5 while B1's allowed rounding moves them by
    ~1e-1, so a token whose top-2 margin lies inside that may flip).
    ``float_check`` False skips the float-weights yardstick (phase 24: the
    W4A4 format is what changes)."""
    import torch

    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    cfg = eng_k.api.cfg
    kp = _compare("kernels vs plain, W4A4 + bcq4",
                  _forward_logits(eng_k.api, eng_k.params, prompts, tokens),
                  _forward_logits(eng_p.api, eng_k.params, prompts, tokens))
    plain = _forward_logits(eng_p.api, eng_k.params, prompts, tokens)
    with b1_tolerance_noise():
        moved = _forward_logits(eng_p.api, eng_k.params, prompts, tokens)
    floor = _compare("plain vs plain with every linear moved by B1's tolerance (noise floor)",
                     moved, plain)
    if kp["max"] > floor["max"] or kp["rms"] > floor["rms"]:
        fail(f"kernel path differs from the plain path ({kp}) beyond the plain path's own "
             f"noise floor at B1's tolerance ({floor})")
    nudged = dict(eng_k.params, embed={"kernel": eng_k.params["embed"]["kernel"] * (1 + 2**-22)})
    ulp = _compare("plain vs plain with a 1-ulp embedding scale (the margin rule's tolerance)",
                   _forward_logits(eng_p.api, nudged, prompts, tokens), plain)
    tol = ulp["max"] if margin == "ulp" else floor["max"]
    if not float_check:
        return tol
    apis = [zoo.build(cfg, Runtime(quant_mode="none", compute_dtype=torch.float32,
                                   cache_kind="bf16", paged_kernel=k), device="cuda")
            for k in (True, False)]
    params = apis[0].init(0)
    fl = _compare("kernels vs plain, float weights + bf16 pages",
                  _forward_logits(apis[0], params, prompts, tokens),
                  _forward_logits(apis[1], params, prompts, tokens))
    if fl["max"] > 1e-3 * fl["scale"]:
        fail(f"without W4A4 the kernel path must agree to rounding: {fl}")
    return tol


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


EVENTS_TIMER = "the whole call between CUDA events (the profiler saw none of its kernels)"


def timer(by_name):
    """What timed a ``kernel_split_ms`` result."""
    return EVENTS_TIMER if EVENTS_TIMER in by_name else "torch.profiler"


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


def check_eval_launches(api, params, batch, expect=None):
    """Hold every flash and fused-linear launch of one evaluation forward
    against its plain version on the very inputs the forward gave it (the
    launches of this check are not counted toward the main path's);
    ``expect``: the launches by kernel (a dense model's by default).
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
    expect = expect or {"flash_attention": api.cfg.n_layers, "bcq_linear": 6 * api.cfg.n_layers}
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
CORE_EOS_AT = 7  # eos_id = a greedy request's token at this position or the first later one
# where it is the first time any request decoded it
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

        def run_decode(packed, key, real=eng._run_decode):
            tok = torch.where(packed[:, 1] == 1, packed[:, 0], eng._chain_tok)
            lp, _ = api_p.paged_decode_fn(eng.params, {n: t.clone() for n, t in eng.pool.items()},
                                          tok[:, None], packed[:, 3:], packed[:, 2])
            out = real(packed, key)
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
    # 5. EOS: the token a greedy request emitted at the first position from
    # CORE_EOS_AT on where that is the first time any request decoded it
    def first_eos(tok):
        return min(((r.launch_ids[p], key, p) for key, r in fin_k.items()
                    for p in range(1, len(r.out)) if r.out[p] == tok), default=None)

    pick = next((first_eos(r.out[at]) for at in range(CORE_EOS_AT, GEN - 1)
                 for key, r in sorted(fin_k.items())
                 if r.sampling.greedy and key[0] != CORE_FORK
                 and first_eos(r.out[at])[1:] == (key, at)), None)
    if pick is None:
        fail(f"phase 11: no greedy request's token at a position from {CORE_EOS_AT} to "
             f"{GEN - 2} is a first occurrence")
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
COUNTED = ("bcq_linear", "page_gather", "bcq_page_write")


def _tick_profile(fn, n):
    """``fn`` called ``n`` times under torch.profiler: (CUDA kernels, device
    busy ms) per call, or None where the profiler saw no device kernel."""
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
    return len(kern) / n, sum(e.time_range.elapsed_us() for e in kern) / n / 1e3


def _steady_profile(eng, label, rows, n=3, tries=3):
    """``_tick_profile`` of ``n`` steady ticks of ``eng`` (``rows`` rows
    decoding), for the device-busy numbers only: the ticks of a window are
    alike, so a window with no device kernel, or with a kernel count that is
    not a whole number a tick, is one where the profiler dropped events: it
    is profiled again, up to ``tries`` windows, and the last one stands
    (None: "not measured").  The host-launch checks read ``_host_launches``
    instead, which needs no device event."""
    for _ in range(tries):
        if sum(s.req is not None for s in eng.slots) != rows:
            fail(f"{label}: the steady window lost a decoding row")
        prof = _tick_profile(eng.step, n)
        if prof is not None and abs(prof[0] * n - round(prof[0] * n)) < 1e-6:
            return prof
        print(f"  ({label}: torch.profiler dropped events of a steady window of {n} ticks "
              f"{prof}; profiled again)", flush=True)
    return prof


# aten ops on CUDA tensors that launch no kernel: allocations, metadata,
# a device-to-host read of one value; a copy launches none when it is a
# plain memcpy (``_copy_is_memcpy``)
NO_KERNEL_OPS = {"aten.empty.memory_format", "aten.empty_strided.default",
                 "aten.empty_like.default", "aten.new_empty.default",
                 "aten.new_empty_strided.default", "aten._local_scalar_dense.default",
                 "aten.record_stream.default", "aten.is_pinned.default",
                 "aten.detach.default", "aten.alias.default", "aten.lift_fresh.default"}
COPY_OPS = {"aten.copy_.default", "aten._to_copy.default", "aten.clone.default"}


def _cuda_tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree] if tree.device.type == "cuda" else []
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _cuda_tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _cuda_tensors(x)]
    return []


def _copy_is_memcpy(args, out) -> bool:
    """A copy between tensors of one dtype, each contiguous: a memcpy (the
    copy kernels run only to convert or to gather strided data)."""
    import torch

    ts = [t for t in (list(args) + [out]) if isinstance(t, torch.Tensor)]
    return len({t.dtype for t in ts}) == 1 and all(t.is_contiguous() for t in ts)


def _host_launches(eng, label, rows, n=3):
    """What ``n`` steady ticks of ``eng`` (``rows`` rows decoding) issue from
    the host, measured without the profiler's device events (which it has
    lost on this card): the decode graphs' replays (``DecodeGraphs.replays``)
    and the eager CUDA kernels — a dispatch-mode record of every aten op
    that touches a CUDA tensor, less views, allocations and plain memcpys
    (each other op launches a kernel), and the port's own kernels launched
    outside a replay (the launch counters' growth less what the replays
    added).  Returns (kernels a tick, replays a tick, the kernels' names)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import build

    if sum(s.req is not None for s in eng.slots) != rows:
        fail(f"{label}: the steady window lost a decoding row")
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if _cuda_tensors([args, kwargs or {}, out]) and not (
                    name in NO_KERNEL_OPS or func.is_view
                    or (name in COPY_OPS and _copy_is_memcpy(args, out))):
                ops.append(name)
            return out

    graphs, replayed = eng._graphs, {}
    if graphs is not None:
        real_run = graphs.run

        def run(key):  # a bucket with a graph replays; its launches are the capture's deltas
            replay = graphs.buckets[key].graph is not None
            out = real_run(key)
            for name, d in (graphs.buckets[key].deltas.items() if replay else ()):
                replayed[name] = replayed.get(name, 0) + d
            return out

        graphs.run = run
    before, replays = build.counts(), graphs.replays if graphs is not None else 0
    try:
        with Record():
            for _ in range(n):
                eng.step()
        torch.cuda.synchronize()
    finally:
        if graphs is not None:
            del graphs.run  # the instance attribute; the method shows through again
    for name, c in build.counts().items():
        ops += [name] * (c - before.get(name, 0) - replayed.get(name, 0))
    replays = (graphs.replays - replays) if graphs is not None else 0
    return len(ops) / n, replays / n, sorted(set(ops))


def _host_txt(host):
    return (f"host, a tick: {host[1]:.0f} graph replay + {host[0]:.0f} eager kernel launches "
            f"(dispatch record){' ' + str(host[2]) if host[2] else ''}")


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
    kern, busy = prof
    return (f"device busy {busy:.3f} ms/tick, idle share {max(0.0, 1 - busy / wall):.3f}, "
            f"{kern:.0f} CUDA kernels/tick")


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
    host = _host_launches(eng, label, len(prompts))
    eng.run_to_completion()
    torch.cuda.synchronize()
    again = eng.trace_counts()["decode"] - captures
    if again:
        fail(f"{label} [{_way_name(graphs, depth)}]: the warmed engine captured {again} more")
    print(f"{label} [{_way_name(graphs, depth)}] phase 4's workload: run {run_s:.2f} s "
          f"({out[1]['decode_ticks']} decode ticks, {out[1]['prefill_launches']} prefill "
          f"launches), captures {captures} fresh / {again} warmed; steady tick (8 rows, "
          f"{n_time} ticks): wall {wall:.2f} ms/tick, {_profile_txt(prof, wall)}; "
          f"{_host_txt(host)}", flush=True)
    nodes = {w: eng._graphs.node_count(w) for w in eng._graphs.buckets} if graphs else {}
    return {"out": out, "pool": pool, "counts": counts, "wall": wall, "prof": prof,
            "host": host, "captures": captures, "nodes": nodes, "engine": eng}


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
    prof = tuple(float(np.mean([p[i] for p in profs])) for i in range(2)) if profs else None
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
        if w["host"][:2] != (0, 1):
            fail(f"phase 12 [{name}]: a steady greedy tick issued {w['host']} (eager kernel "
                 "launches, graph replays, ops) from the host")
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
    if w["nodes"] != g2["nodes"] or not w["nodes"] or w["host"][:2] != (0, 1):
        fail(f"phase 13: the default engine's steady greedy graph tick with audit_every=8 "
             f"(graph nodes {w['nodes']}; eager kernel launches, graph replays a tick "
             f"{w['host']}) is not phase 12's (graph nodes {g2['nodes']}; {g2['host']})")
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
          f"{g2['nodes']}); torch.profiler: "
          + ("not measured (no device event)" if prof is None or g2["prof"] is None else
             f"{prof[0]:.2f} CUDA kernels/tick (phase 12's {g2['prof'][0]:.2f}; the earlier run "
             f"{EARLIER_TICK[0]})")
          + f"; {_host_txt(w['host'])}; card {smi}", flush=True)
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


def _opt(v, spec=".4f", unit=" ms"):
    return "not measured" if v is None else f"{v:{spec}}{unit}"


def encode_in_route(fn, bound, what, iters=20, tries=3):
    """B3's device ms a call of ``fn`` (the mean of the profiler events it
    got), the whole call's device ms and CUDA kernels a call, and what
    timed them.  A window that saw B3 fewer than ``iters / 2`` times, or
    below ``bound``, is profiled again, up to ``tries`` times; then B3's
    share and the kernel count are not measured, and the whole call is
    timed between CUDA events."""
    for _ in range(tries):
        got = _device_kernels(fn, iters)
        if got is None:
            continue
        n_kern, route_dev, by_name, seen = got
        enc = [nm for nm in by_name if "encode_kernel" in nm]
        if len(enc) == 1 and seen[enc[0]] >= iters / 2:
            dev = by_name[enc[0]] * iters / seen[enc[0]]
            if dev >= bound:
                return dev, route_dev, n_kern, "torch.profiler"
    print(f"  ({what}: torch.profiler lost B3's launches in {tries} windows of {iters} calls; "
          f"the whole call timed between CUDA events)", flush=True)
    return None, cuda_ms(fn, iters=iters, warmup=1), None, EVENTS_TIMER


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
        dev, probe_dev, n_kern, how = encode_in_route(lambda: bcq.encode_stats(x, cb, cfg),
                                                      bound, f"B3's probe at M={m} K={k}")
        out[k] = {"shape": f"M {m} K {k} (decode probe)", "ms": ms, "device_ms": dev,
                  "probe_device_ms": probe_dev, "probe_kernels": n_kern, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": None}
        print(f"B3 probe form (encode_stats) at M={m} K={k}: {ms:.4f} ms a probe (event loop), "
              f"B3's encode {_opt(dev)} device, the probe's {_opt(n_kern, '.0f', '')} kernels "
              f"{probe_dev:.4f} ms device ({how}), plain encode_stats {plain_ms:.4f} ms, B3 bound "
              f"{bound:.5f} ms by {by}", flush=True)
    return {**out[768], "at_k3072": out[3072]}


def phase_telemetry(eng4, cb, g2, core_g2, smi):
    """Phase 14: telemetry on the card.  Phase 11's workload at graph depth
    2 at the "counters" level, held bit for bit to phase 12's run (which
    has the default level: histograms, timelines, journal): equal
    device_syncs; that run's TTFT and ITL counts, and its metrics and
    trace accepted by ``tools/check_telemetry.py``.  Phase 4's workload on
    a counters-level engine beside phase 12's default one: the same graph
    nodes, bits and device_syncs, 1 graph replay and 0 eager kernel
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
        if w["host"][:2] != (0, 1):
            fail(f"phase 14: the {name} level's steady greedy tick: {w['host']}")
    if wc["nodes"] != g2["nodes"] or not wc["nodes"] or syncs(wc["engine"]) != syncs(g2["engine"]):
        fail(f"phase 14: the counters level's decode graph ({wc['nodes']} nodes, "
             f"{syncs(wc['engine'])} syncs) is not the default level's ({g2['nodes']}, "
             f"{syncs(g2['engine'])})")
    print(f"phase 14 phase 4's workload, graph depth 2: default level (phase 12's engine) and "
          f"counters level equal bit for bit; decode graph nodes {g2['nodes']} at both (an "
          f"earlier run: {EARLIER_DEFAULT_TICK[0]}); 1 graph replay and 0 eager kernel launches "
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
    if wp["host"][:2] != (0, 1):
        fail(f"phase 14: the probe engine's steady tick: {wp['host']}")
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
    if w["nodes"] != g2["nodes"] or not w["nodes"] or w["host"][:2] != (0, 1) \
            or w["engine"].health()["swap"]["swap_outs"]:
        fail(f"phase 15: the idle tier's steady tick (graph nodes {w['nodes']}; {w['host']}) is "
             f"not phase 12's ({g2['nodes']}; {g2['host']})")
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
MOE_LAYERS = 2  # of Moonlight's 48: the depth cut that keeps the script in its time (width whole)
MOE_PLAIN_LAYERS = 4  # depth of the whole-run kernel vs plain comparison (its tolerance's premise)
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
        fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
        print(f"phase 16 stacked fused linear timing at E={e} C={c} K={k} N={n}: kernel "
              f"{ms:.4f} ms (device {split['device_ms']:.4f} ms: encode pass "
              f"{fmt(split['encode_ms'])}, GEMM {fmt(split['gemm_ms'])}, {split['timer']}), "
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
    """Phase 16: full-width Moonlight-16B-A3B (``moonshot_v1_16b``: d 2048,
    16 heads of 128, 64 experts top-6, d_ff_expert 1408, vocab 163840; its
    depth cut to ``MOE_LAYERS`` of 48 layers; seeded random weights drawn
    and packed to W4 a layer at a time on the card) served in W4A4 from
    bcq4 pages through the kernels,
    phase 4's settings and requests: the production tick (graph depth 2)
    and eager depth 1 equal bit for bit (tokens, margins, launch indices,
    counters, pool bytes, launch counts), exact launch counts (the stacked
    B1 3 a layer and pass, the dense B1 4, B2 and the writer 1), every
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
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
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

    # whole runs at MOE_PLAIN_LAYERS of the same width: kernels vs plain paths
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
          f"2) vs plain (eager depth 1) under the margin rule (logit tol {tol:.3e}, the 1-ulp "
          f"scale's change): {agree}", flush=True)
    if not agree["ok"]:
        fail("phase 16: the kernel and plain runs disagree beyond the margin rule")
    # the whole-run comparison stops at the first launch whose tokens part;
    # phase 11's workload at MOE_PLAIN_LAYERS holds every launch to the plain paths
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
PPL_BAR = 1.10  # W4A4 perplexity below this × the float one: tests/test_system.py:89


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


def _expect(counts, want, what, label="phase 17"):
    got = {k: counts.get(k, 0) for k in want}
    if got != want or any(v for k, v in counts.items() if k not in want):
        fail(f"{label} {what}: launches {counts}, expected {want} and no other")


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
    float weights, of the fake artifact under every act_format, of the
    float weights quantized in the forward (``fake_full``), and of the
    packed artifact; launch counts
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
    runs = [("float", base, floats, {"flash_attention": L * nb})]
    runs += [(f"fake {f}", dataclasses.replace(base, quant_mode="fake", act_format=f), fake,
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
        dev, route_dev, n_kern, how = encode_in_route(lambda: bcq.fake_quant(x, cb, cfg),
                                                      bound, f"B3's fake-quant at M={m} K={k}")
        out[m] = {"shape": f"M {m} K {k}", "ms": ms, "device_ms": dev,
                  "route_device_ms": route_dev, "route_kernels": n_kern, "plain_ms": plain_ms,
                  "bound_ms": bound, "bound_by": by, "library_ms": None}
        print(f"B3 fake-quant form (bcq.fake_quant) at M={m} K={k}: {ms:.4f} ms a call (event "
              f"loop), B3's encode {_opt(dev)} device, the route's {_opt(n_kern, '.0f', '')} "
              f"kernels {route_dev:.4f} ms device ({how}), plain fake_quant_plain "
              f"{plain_ms:.4f} ms, B3 bound {bound:.5f} ms by {by}", flush=True)
    return {**out[8], "at_eval": out[EVAL_SEQ * EVAL_BATCH]}


def phase_ptq(cb, smi, train_ck):
    """Phase 17: the PTQ deploy step on full-width gpt3_126m, trained by
    phase 21.  The trained float weights saved again by the port's
    ``CheckpointManager`` and restored (bytes equal); ``python -m
    repro_torch.launch.quantize``'s ``main`` on the card over phase 21's
    checkpoint (calibration: one batch of 4 × 128 tokens, 15 LO-BCQ
    iterations; the fake and packed artifacts, the manifest); the fit twice
    byte-equal, non-increasing, equal to the port's CPU fit; the held-out
    loss of the float weights, of the fake artifact under every act_format,
    of ``fake_full`` and of the packed artifact, the W4A4 perplexity held
    to the reference's bar (``tests/test_system.py::test_ptq_pipeline_ppl_close``:
    below ``PPL_BAR`` × the float perplexity and below the int4 baseline's);
    both artifacts served at graph depth 2 ≡ eager depth 1 with every launch
    of a prefill and a steady tick held to plain.  Returns (the phase's
    launches by kernel, the worst B1 / B2 / B5 errors, B3's fake-quant
    form)."""
    import math
    import shutil

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager, load_pytree
    from repro_torch.configs.base import get_arch
    from repro_torch.core import ptq
    from repro_torch.core.bcq import BCQConfig, CodebookSet
    from repro_torch.data.pipeline import DataConfig, batch_at, eval_stream
    from repro_torch.launch import quantize
    from repro_torch.models import zoo

    t_phase = time.perf_counter()
    cfg = get_arch("gpt3_126m")
    shutil.rmtree(PTQ_DIR, ignore_errors=True)
    ck, out = os.path.join(PTQ_DIR, "ckpt"), os.path.join(PTQ_DIR, "w4")
    train_step, train_state = CheckpointManager(train_ck).restore()
    params = zoo._to(train_state["params"], "cuda")
    del train_state
    t0 = time.perf_counter()
    mgr = CheckpointManager(ck, keep=2)
    mgr.save(1, {"params": params})  # the async writer
    mgr.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, state = mgr.restore()
    restore_s = time.perf_counter() - t0
    mine, back = _flat(params), _flat(state["params"])
    if step != 1 or [p for p, _ in mine] != [p for p, _ in back] or not all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b) for (_, a), (_, b) in zip(mine, back)):
        fail("phase 17: the restored checkpoint differs from the saved weights")
    ck_bytes = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
    print(f"phase 17 checkpoint: phase 21's weights (step {train_step}), {len(mine)} leaves, "
          f"{ck_bytes} B on disk, saved again (async writer) in {save_s:.2f} s, restored in "
          f"{restore_s:.2f} s, every leaf equal bit for bit", flush=True)

    totals = {}
    t0 = time.perf_counter()
    manifest, counts = _counted(lambda: quantize.main(["--ckpt", train_ck, "--out", out]), totals)
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
    ppl = {k: math.exp(v) for k, v in losses.items()}
    print("phase 17 perplexity of the trained model: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ppl.items()) + f"; W4A4 (fake bcq) / float "
        f"{ppl['fake bcq'] / ppl['float']:.4f} (bar {PPL_BAR}), int4 activations / float "
        f"{ppl['fake int4'] / ppl['float']:.4f}", flush=True)
    if not ppl["fake bcq"] < PPL_BAR * ppl["float"]:
        fail(f"phase 17: the trained model's W4A4 perplexity {ppl['fake bcq']:.4f} is not below "
             f"{PPL_BAR} × its float perplexity {ppl['float']:.4f}")
    if not ppl["fake bcq"] < ppl["fake int4"]:
        fail(f"phase 17: the trained model's W4A4 perplexity {ppl['fake bcq']:.4f} is not below "
             f"the int4-activation baseline's {ppl['fake int4']:.4f}")
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
    return totals, worst, fake_form, losses


# ------------------------------------------------------------------ phase 21
TRAIN_DIR = os.path.join(ROOT, "build", "train")  # under the ignored build/
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 200, 20, 1e-3  # the CLI's lr and warmup
TRAIN_LOG = 25
TRAIN_DROP = 0.5  # nat: the held-out loss must fall by more (tests/test_system.py:41's bar)
# the SIGTERM check: full width, 1 × 2048 tokens a step (a short run), killed
# after step 4's log line, 8 steps
RESUME_STEPS, RESUME_KILL_AFTER, RESUME_BATCH = 8, 4, 1
FAKE_STEPS = 2  # --quant fake steps from the trained weights
TIME_STEPS = 2  # steps a timing window
# the threshold search's operations per scalar: per codebook 4 compares, a
# level read, d, d², Σ; 4 compares more for the winner's index
THR_ENCODE_OPS = 8 * (4 + 1 + 3) + 4


def _train_args(steps, ckpt, *extra, batch=EVAL_BATCH):
    return ["--arch", "gpt3_126m", "--batch", str(batch), "--seq", str(EVAL_SEQ),
            "--steps", str(steps), "--warmup", str(TRAIN_WARMUP), "--lr", str(TRAIN_LR),
            "--save-every", str(steps + 1), "--ckpt", ckpt, *extra]


def _ckpt_tree(path):
    from repro_torch.checkpoint.manager import CheckpointManager

    return CheckpointManager(path).restore()


def _flat(tree, p=""):
    """(path, leaf) of nested dicts in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{p}/{k}")]
    return [(p, tree)]


def _held_out(api, params, dcfg):
    """The train CLI's held-out loss: the mean over 4 eval_stream batches."""
    import torch

    from repro_torch.data.pipeline import eval_stream

    with torch.no_grad():
        return float(np.mean([float(api.loss_fn(params, b))
                              for b in eval_stream(dcfg, 4, device="cuda")]))


def train_timing(api, params, opt, batch):
    """ms/step of the train step on the trained state (the same inputs each
    step: the update is out of place) with and without the deterministic
    algorithms, in turns (on, off, off, on), and one profiled window of the
    deterministic step: (ms on, ms off, the windows' ms, (CUDA kernels,
    device busy ms) a step or None)."""
    import contextlib

    import torch

    from repro_torch.launch import train
    from repro_torch.optim import adamw

    step = train.make_train_step(api, adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                                        total_steps=TRAIN_STEPS))

    def window(det):
        with train.deterministic() if det else contextlib.nullcontext():
            step(params, opt, batch)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIME_STEPS):
                step(params, opt, batch)
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / TIME_STEPS

    ms = {True: [], False: []}
    for det in (True, False, False, True):
        ms[det].append(window(det))
    with train.deterministic():
        prof = _tick_profile(lambda: step(params, opt, batch), TIME_STEPS)
    return float(np.mean(ms[True])), float(np.mean(ms[False])), ms, prof


# A15 on the trained model: bf16 scores against f32 in one train step, and
# the query chunk of one held-out evaluation forward.  The bound on the
# step's |Δloss|: bf16 rounds each score and each p to 2^-9 relative, errors
# that average over 2,048 keys, so the loss should move by ~1e-3 nat; 1e-2
# nat is a 1.01× perplexity ratio, a tenth of phase 17's W4A4 bar (1.10×).
ATTN_BF16_LOSS_TOL = 1e-2
ATTN_CHUNKS = (256, EVAL_SEQ)  # the evaluation forward's query chunks
# the chunked evaluation's logits against the one-chunk forward's, a
# fraction of max|logit|: rows are independent, but the two score products
# take other cuBLAS kernels (other M), so an f32 sum may round a bf16
# activation the other way, a 2^-8 step that 12 layers carry on
ATTN_CHUNK_LOGIT_TOL = 2**-5


def train_attention(cfg, params, opt, batch, dcfg):
    """A15 on the trained state: one train step (deterministic algorithms
    on, as the CLI) with f32 scores (``Runtime()``) and with bf16 scores
    (``Runtime(attn_f32=False)``) in turns (f32, bf16, bf16, f32), each
    way's ms/step, peak device memory and loss, |Δloss| held within
    ``ATTN_BF16_LOSS_TOL``; then one held-out evaluation forward under
    ``no_grad`` at each ``ATTN_CHUNKS`` query chunk: the peak memory it adds
    above what is resident, and its logits, held to the one-chunk run's
    within ``ATTN_CHUNK_LOGIT_TOL`` · max|logit|.  Returns the numbers."""
    import torch

    from repro_torch.data.pipeline import eval_stream
    from repro_torch.launch import train
    from repro_torch.models import transformer, zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import adamw

    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    steps = {f32: train.make_train_step(zoo.build(cfg, Runtime(attn_f32=f32), device="cuda"),
                                        opt_cfg) for f32 in (True, False)}
    ms, peak, loss = {True: [], False: []}, {}, {}
    with train.deterministic():
        for f32 in (True, False, False, True):
            steps[f32](params, opt, batch)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(TIME_STEPS):
                out = steps[f32](params, opt, batch)
            torch.cuda.synchronize()
            ms[f32].append(1e3 * (time.perf_counter() - t0) / TIME_STEPS)
            peak[f32] = torch.cuda.max_memory_allocated() / 1e9
            loss[f32] = float(out[2]["loss"])
            del out
    d_loss = abs(loss[False] - loss[True])
    if not (np.isfinite(loss[False]) and d_loss <= ATTN_BF16_LOSS_TOL):
        fail(f"phase 21: one train step's loss is {loss[False]!r} with bf16 scores, {loss[True]!r} "
             f"with f32: |Δ| {d_loss:.3e} > {ATTN_BF16_LOSS_TOL}")
    tokens = next(iter(eval_stream(dcfg, 1, device="cuda")))["tokens"]
    ev = {}
    for chunk in ATTN_CHUNKS:
        rt = Runtime(attn_chunk=chunk)
        with torch.no_grad():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            hid = transformer.forward_hidden(params, tokens, cfg, rt)
            torch.cuda.synchronize()
            added = (torch.cuda.max_memory_allocated() - base) / 1e9
            ev[chunk] = (added, transformer.lm_logits(params, hid, rt).float())
            del hid
    small, whole = ev[ATTN_CHUNKS[0]][1], ev[ATTN_CHUNKS[1]][1]
    tol = ATTN_CHUNK_LOGIT_TOL * float(whole.abs().max())
    ok, err = held(small, whole, 0.0, tol)
    if not ok:
        fail(f"phase 21: the evaluation logits at attn_chunk {ATTN_CHUNKS[0]} differ from one "
             f"chunk's by {err:.3e} > {tol:.3e}")
    same = bool(torch.equal(small, whole))
    return {"ms": {"f32": float(np.mean(ms[True])), "bf16": float(np.mean(ms[False]))},
            "turns": ms, "peak_gb": {"f32": peak[True], "bf16": peak[False]},
            "loss": {"f32": loss[True], "bf16": loss[False]}, "d_loss": d_loss,
            "eval_added_gb": {c: ev[c][0] for c in ATTN_CHUNKS}, "eval_logit_err": err,
            "eval_logits_equal": same}


def start_killed_run():
    """The run to be preempted: a subprocess of the train CLI (full width,
    ``RESUME_BATCH`` × 2048 tokens a step), sent SIGTERM after its step-4
    log line; the hook sets its flag, the loop writes the snapshot at the
    next step boundary and the process keeps running (the default handler
    is not callable), so it is killed once the snapshot's sidecar has
    landed.  A watcher thread does both while this
    process goes on (phase 21's main run).  Returns (the process, the
    watcher, what went wrong, its output lines)."""
    import atexit
    import signal
    import threading

    killed = os.path.join(TRAIN_DIR, "killed")
    os.makedirs(killed, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           *_train_args(RESUME_STEPS, killed, "--log-every", "1", batch=RESUME_BATCH)]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    atexit.register(proc.kill)  # a failed phase leaves no process behind
    seen, why = [], []

    def watch():
        for line in proc.stdout:
            seen.append(line.rstrip())
            if line.startswith(f"step {RESUME_KILL_AFTER} loss"):
                break
        else:
            why.append(f"the run to be killed ended before step {RESUME_KILL_AFTER}")
            return
        proc.send_signal(signal.SIGTERM)
        deadline = time.time() + 180
        while not [f for f in os.listdir(killed) if f.endswith(".npz.json")]:
            if proc.poll() is not None or time.time() > deadline:
                why.append("no SIGTERM snapshot landed" + (
                    f" (the run exited {proc.returncode})" if proc.poll() is not None else ""))
                return
            time.sleep(0.02)
        if proc.poll() is not None:
            why.append(f"the SIGTERM'd run exited ({proc.returncode}): the hook must leave it "
                       "running under the default handler")
        proc.kill()

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return proc, watcher, why, seen


def train_kill_resume(killer):
    """The preempted run (``start_killed_run``) resumed from its snapshot
    ends bit-equal, in every leaf of params and optimizer state, to the
    uninterrupted run; both run here.  Returns (the snapshot's step,
    seconds of this part)."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import train

    t0 = time.perf_counter()
    proc, watcher, why, seen = killer
    try:
        watcher.join(timeout=300)
    finally:
        proc.kill()
        proc.wait()
    if watcher.is_alive() or why:
        fail(f"phase 21: {why or ['the watcher did not finish']}: " + " | ".join(seen[-5:]))
    straight, killed = os.path.join(TRAIN_DIR, "straight"), os.path.join(TRAIN_DIR, "killed")
    snap = sorted(f for f in os.listdir(killed) if f.endswith(".npz.json"))
    snap_step = int(snap[-1][5:13])
    if len(snap) != 1 or not RESUME_KILL_AFTER <= snap_step < RESUME_STEPS:
        fail(f"phase 21: the killed run left {snap}, expected one snapshot of a step in "
             f"[{RESUME_KILL_AFTER}, {RESUME_STEPS})")
    with contextlib.redirect_stdout(io.StringIO()):
        train.main(_train_args(RESUME_STEPS, straight, "--log-every", "1", batch=RESUME_BATCH))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(_train_args(RESUME_STEPS, killed, "--log-every", "1", batch=RESUME_BATCH))
    if f"resumed from step {snap_step}" not in out.getvalue():
        fail(f"phase 21: the rerun did not resume from step {snap_step}:\n{out.getvalue()}")
    (sa, ta), (sb, tb) = _ckpt_tree(straight), _ckpt_tree(killed)
    fa, fb = _flat(ta), _flat(tb)
    if sa != sb or [p for p, _ in fa] != [p for p, _ in fb]:
        fail(f"phase 21: the resumed checkpoint (step {sb}) does not match the uninterrupted "
             f"one's leaves (step {sa})")
    diff = [p for (p, a), (_, b) in zip(fa, fb) if a.dtype != b.dtype or not torch.equal(a, b)]
    if diff:
        fail(f"phase 21: killed at step {snap_step} and resumed, {len(diff)} of {len(fa)} leaves "
             f"differ from the uninterrupted run's: {diff[:6]}")
    print(f"phase 21 SIGTERM and resume: a run of {RESUME_STEPS} steps of {RESUME_BATCH} × "
          f"{EVAL_SEQ} tokens (a subprocess of the CLI) sent SIGTERM after step "
          f"{RESUME_KILL_AFTER}'s log line wrote its snapshot at step {snap_step} and kept running "
          f"(killed after the snapshot landed); the rerun resumed from step {snap_step} and ended "
          f"bit-equal to the uninterrupted run in all {len(fa)} leaves of params and optimizer "
          f"state ({time.perf_counter() - t0:.1f} s after the main run)", flush=True)
    return snap_step, time.perf_counter() - t0


def fake_train(trained, totals):
    """``--quant fake`` at full width from the trained weights (the CLI
    resumes a step-0 checkpoint of them with the universal codebooks and a
    fresh optimizer state), every B3 launch held to ``quantize_ref`` on its
    own inputs.  Returns (launches by kernel, B3 launches held, ties, the
    threshold search's launches, the final tree)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.calibrate import default_universal_codebooks
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    ck = os.path.join(TRAIN_DIR, "fake")
    params = dict(trained, codebooks=default_universal_codebooks().as_tensor("cuda"))
    CheckpointManager(ck).save(0, {"params": params, "opt": adamw.init_state(params)},
                               blocking=True)
    args = _train_args(FAKE_STEPS, ck, "--quant", "fake", "--log-every", "1")
    (out, n, ties), counts = _counted(
        lambda: hold_fake_route(lambda: train.main(args), "phase 21 --quant fake"), totals)
    L = 12
    want = 4 * L * (FAKE_STEPS + 4)  # 4 activations a layer: the steps, then 4 eval forwards
    thr = counts.get("bcq_quantize_thr", 0)
    if counts.get("bcq_quantize", 0) != want or n != want or thr != want - 4 * L:
        fail(f"phase 21 --quant fake: launches {counts}, {n} held; expected {want} B3 launches, "
             f"{want - 4 * L} of them the threshold search (the books are non-integer after the "
             "first step)")
    _, state = _ckpt_tree(ck)
    return counts, n, ties, thr, state["params"], out[1]


def fake_grads_equal(params, batch, api=None, label="phase 21"):
    """One fake-quant step's loss and every gradient leaf through B3's route
    against the plain route on the same inputs (phase 21: trained,
    non-integer codebooks); every B3 launch held and its ties counted.
    ``api``: the fake-quant model (default full-width gpt3_126m).  Returns
    (leaves bit-equal, leaves, ties, launches held, the max |Δ| of the
    codebook gradient)."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    if api is None:
        api = zoo.build(get_arch("gpt3_126m"), Runtime(quant_mode="fake"), device="cuda")
    with train.deterministic():
        (kl, kg), n, ties = hold_fake_route(lambda: train.value_and_grad(api.loss_fn, params, batch),
                                            f"{label} gradient step")
        real = bcq.fake_quant
        bcq.fake_quant = bcq.fake_quant_plain
        try:
            pl, pg = train.value_and_grad(api.loss_fn, params, batch)
        finally:
            bcq.fake_quant = real
    torch.cuda.synchronize()
    if not torch.equal(kl, pl):
        fail(f"{label}: the fake-quant loss through B3's route ({float(kl)!r}) differs from the "
             f"plain route's ({float(pl)!r})")
    fk, fp = _flat(kg), _flat(pg)
    same = [torch.equal(a, b) for (_, a), (_, b) in zip(fk, fp)]
    cb_diff = float((kg["codebooks"] - pg["codebooks"]).abs().max())
    for (path, a), (_, b), eq in zip(fk, fp, same):
        if eq:
            continue
        if path == "/codebooks" and ties:
            continue  # a codebook tie moved a block's share of the codebook gradient
        fail(f"{label}: the gradient of {path} through B3's route differs from the plain "
             f"route's by {float((a - b).abs().max()):.3e} ({ties} ties)")
    if not bool(torch.isfinite(kg["codebooks"]).all()) or float(kg["codebooks"].abs().max()) == 0:
        fail(f"{label}: the codebook gradient is zero or non-finite")
    return sum(same), len(same), ties, n, cb_diff


def time_trained_books(books):
    """B3 at (8192, 768) on trained (non-integer) books: the threshold
    search, beside the table on the integer books, the plain encode and the
    bound (its operations per scalar: ``THR_ENCODE_OPS``)."""
    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_quantize as bq
    from repro_torch.kernels.ref import quantize_ref

    cfg = bcq.BCQConfig()
    m, k = EVAL_SEQ * EVAL_BATCH, 768
    x = activation(m, k, 7)
    s_x = bcq.tensor_scale(x, cfg)
    ms = cuda_ms(lambda: bq.bcq_quantize(x, books, s_x, cfg))
    plain_ms = cuda_ms(lambda: quantize_ref(x, books, cfg, s_x), iters=5)
    nbytes = m * k * 4 + m * k // 2 + m * k // 16 + m * k // 64 * 4 + 8 * 16 * 4 + 4
    ops = THR_ENCODE_OPS * m * k
    bound, by = _bound(nbytes, (ops, F32_FLOPS))
    by_name = kernel_split_ms(lambda: bq.bcq_quantize(x, books, s_x, cfg), bound,
                              f"bcq_quantize (threshold search) at M={m} K={k}")
    dev = device_ms(by_name)
    print(f"B3 threshold search (trained books) at M={m} K={k}: kernel {ms:.4f} ms (device "
          f"{dev:.4f} ms, {timer(by_name)}), plain {plain_ms:.4f} ms, bound {bound:.5f} ms by "
          f"{by} ({nbytes} B, {ops} f32 operations)", flush=True)
    return {"shape": f"M {m} K {k}, trained books", "ms": ms, "device_ms": dev,
            "timer": timer(by_name), "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def phase_train(smi):
    """Phase 21: training full-width gpt3_126m through ``launch.train.main``
    on the card (bf16 compute, f32 parameters, 4 × 2048 tokens a step):
    the held-out loss falls by more than ``TRAIN_DROP``; ms/step, tokens/s,
    the idle share and the cost of the deterministic algorithms; a run
    killed by SIGTERM and resumed ends bit-equal to the uninterrupted one;
    ``--quant fake`` steps from the trained weights through B3 (its
    threshold search after the first step), every launch held to plain;
    one fake step's loss and gradients through B3 equal to the plain
    route's.  Returns (B3's launches of the fake run, the trained
    checkpoint's directory, B3's entry for trained books: its threshold
    search's launches and time at (8192, 768), the step's numbers)."""
    import gc
    import shutil

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    t_phase = time.perf_counter()
    cfg = get_arch("gpt3_126m")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    main_ck = os.path.join(TRAIN_DIR, "main")
    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: the subprocess needs room
    killer = start_killed_run()
    api = zoo.build(cfg, Runtime(), device="cuda")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=EVAL_SEQ, global_batch=EVAL_BATCH, seed=0)
    before = _held_out(api, api.init_train(0), dcfg)

    torch.cuda.synchronize()
    build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, after = train.main(_train_args(TRAIN_STEPS, main_ck, "--log-every", str(TRAIN_LOG)))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(build.counts().values()):
        fail(f"phase 21: the float training run launched kernels {build.counts()}: its step "
             "has none (no kernel of the reference has a backward)")
    if not np.isfinite(after) or not before - after > TRAIN_DROP:
        fail(f"phase 21: the held-out loss went {before:.4f} → {after:.4f}, not down by more than "
             f"{TRAIN_DROP} nat")
    step, state = _ckpt_tree(main_ck)
    if step != TRAIN_STEPS or int(state["opt"]["step"]) != TRAIN_STEPS:
        fail(f"phase 21: the final checkpoint is at step {step}, opt step {state['opt']['step']}")
    trained = zoo._to(state["params"], "cuda")
    opt = zoo._to(state["opt"], "cuda")
    print(f"phase 21 training: full-width gpt3_126m, {TRAIN_STEPS} steps of {EVAL_BATCH} × "
          f"{EVAL_SEQ} tokens (bf16 compute, f32 params, lr {TRAIN_LR}, warmup {TRAIN_WARMUP}) in "
          f"{run_s:.1f} s with the CLI's set-up, eval and final save; held-out loss {before:.4f} → "
          f"{after:.4f} (down {before - after:.4f} nat, bar {TRAIN_DROP}); peak device memory "
          f"{peak_gb:.1f} GB; no kernel launched (the float step runs the plain paths)",
          flush=True)

    batch = {k: v for k, v in batch_at(dcfg, TRAIN_STEPS, device="cuda").items()}
    ms_det, ms_free, turns, prof = train_timing(api, trained, opt, batch)
    tokens = EVAL_BATCH * EVAL_SEQ
    busy = "not measured" if prof is None else f"{prof[1]:.1f} ms"
    idle = None if prof is None else max(0.0, 1 - prof[1] / ms_det)
    print(f"phase 21 train step (deterministic algorithms on, the CLI's): {ms_det:.1f} ms/step, "
          f"{tokens / ms_det * 1e3:.0f} tokens/s, device busy {busy} a step"
          f"{'' if idle is None else f' (idle share {idle:.3f}, {prof[0]:.0f} CUDA kernels)'}; "
          f"off: {ms_free:.1f} ms/step — the determinism costs {ms_det - ms_free:+.1f} ms a step "
          f"({(ms_det / ms_free - 1) * 100:+.1f}%; windows of {TIME_STEPS} steps on, off, off, "
          f"on: {turns[True][0]:.1f}, {turns[False][0]:.1f}, {turns[False][1]:.1f}, "
          f"{turns[True][1]:.1f}); {smi}", flush=True)
    att = train_attention(cfg, trained, opt, batch, dcfg)
    print(f"phase 21 attention (A15), one train step on the trained state, deterministic "
          f"algorithms on: f32 scores {att['ms']['f32']:.1f} ms/step, peak "
          f"{att['peak_gb']['f32']:.2f} GB, loss {att['loss']['f32']:.6f}; bf16 scores "
          f"{att['ms']['bf16']:.1f} ms/step, peak {att['peak_gb']['bf16']:.2f} GB, loss "
          f"{att['loss']['bf16']:.6f} (|Δloss| {att['d_loss']:.3e} ≤ {ATTN_BF16_LOSS_TOL}; "
          f"windows of {TIME_STEPS} steps f32, bf16, bf16, f32: "
          f"{att['turns'][True][0]:.1f}, {att['turns'][False][0]:.1f}, "
          f"{att['turns'][False][1]:.1f}, {att['turns'][True][1]:.1f}); held-out evaluation "
          f"forward ({EVAL_BATCH} × {EVAL_SEQ}, no_grad) adds "
          + ", ".join(f"{gb:.3f} GB at attn_chunk {c}" for c, gb in att["eval_added_gb"].items())
          + f" above the resident memory; logits at chunk {ATTN_CHUNKS[0]} vs one chunk: "
          f"{'bit-equal' if att['eval_logits_equal'] else 'max|Δ| %.3e' % att['eval_logit_err']}; "
          f"{smi}", flush=True)
    del opt

    snap_step, resume_s = train_kill_resume(killer)

    totals = {}
    t0 = time.perf_counter()
    counts, n, ties, thr, fparams, _ = fake_train(trained, totals)
    fake_s = time.perf_counter() - t0
    fparams = zoo._to(fparams, "cuda")
    books = fparams["codebooks"]
    moved = float((books - torch.round(books)).abs().max())
    print(f"phase 21 --quant fake: {FAKE_STEPS} steps from the trained weights through the CLI, "
          f"{n} B3 launches held to quantize_ref ({ties} with a codebook tie), {thr} of them the "
          f"threshold search (the books move off the integers by up to {moved:.2e} after step 1; "
          f"{fake_s:.1f} s)", flush=True)
    same, leaves, gties, gn, cb_diff = fake_grads_equal(fparams, batch)
    print(f"phase 21 fake-quant gradient on the trained books: loss equal bit for bit through "
          f"B3's route and the plain route, {same} of {leaves} gradient leaves bit-equal "
          f"({gn} B3 launches held, {gties} codebook ties; the codebook gradient parts by "
          f"{cb_diff:.3e})", flush=True)
    trained_form = time_trained_books(books)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 21 summary: held-out loss {before:.4f} → {after:.4f}, {ms_det:.1f} ms/step "
          f"({tokens / ms_det * 1e3:.0f} tokens/s), determinism {ms_det - ms_free:+.1f} ms a step, "
          f"SIGTERM at step {snap_step} resumed bit-exact ({resume_s:.1f} s), fake steps' B3 "
          f"launches {counts}; phase 21 {phase_s:.1f} s; {smi}", flush=True)
    return counts.get("bcq_quantize", 0), main_ck, dict(
        trained_form, launches_threshold_search=thr, held=n, ties=ties,
        gradient_leaves_equal=f"{same}/{leaves}", codebook_gradient_max_diff=cb_diff,
        train_ms_per_step=ms_det, train_ms_per_step_nondeterministic=ms_free,
        train_idle_share=idle, attention=att, phase_s=phase_s)


# ------------------------------------------------------------------ phase 18
STATE_ARCH = "mamba2_130m"
STATE_LAYERS = 8  # of Mamba2-130m's 24: the depth cut that keeps the script in its time
STATE_PER_LAYER = 2  # B1 launches a layer and pass: in_proj, out_proj
STATE_PS = 16
STATE_MAX_LEN = -(-(max(PROMPT_LENS) + GEN + 1) // STATE_PS) * STATE_PS  # serve()'s
STATE_PREEMPT_AT = 20  # eager ticks before the preemption (request 7, the youngest)
STATE_HOST_PAGES = 8
STATE_LOGIT_LAYERS = 2  # depth of the whole-model logits check: no W4A4 flip cascade yet
STATE_FLOOR_FRAC = 1e-3  # the noise floor's bound, a fraction of max|logit|
STATE_LOGIT_RTOL = 1e-4  # kernels vs plain logits, a fraction of max|logit| (10 × B1's rtol)


def state_engine(api, params, graphs, depth, **kw):
    """Phase 18's engine: a slot per request, page 16, the CLI's defaults."""
    from repro_torch.serving.state_engine import StatePagedEngine

    return StatePagedEngine(api, params, n_slots=len(PROMPT_LENS), max_len=STATE_MAX_LEN,
                            page_size=STATE_PS, device="cuda", pipeline_depth=depth,
                            cuda_graphs=graphs, **kw)


def _state_submit(eng, prompts, max_new=GEN - 1, **req):
    from repro_torch.serving.generate import Request

    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new, **req))


def _state_outcome(eng):
    """Tokens, margins and launch indices of every request, the engine's
    counters but the clocks, its state and swap counters."""
    out, stats = _outcome(eng)
    h = eng.health()
    return (out, stats, h["state_counters"], h["swap"])


def _state_bits(eng):
    from repro_torch.serving.pages import tree_leaves

    return [t.clone() for t in tree_leaves(eng.live) + tree_leaves(eng.spool)]


def _state_passes(eng):
    """Forward passes of the layer stack: prefills, decode ticks and replayed
    tokens (a replay is a batch-1 decode step each)."""
    st, cs = eng.stats, eng.health()["state_counters"]
    return st["prefill_launches"] - cs["state_restores"] + st["decode_ticks"] + cs["replay_tokens"]


def _state_counts_ok(eng, counts, label):
    want = STATE_PER_LAYER * eng.api.cfg.n_layers * _state_passes(eng)
    if counts.get("bcq_linear", 0) != want:
        fail(f"phase 18 [{label}]: B1 launched {counts.get('bcq_linear', 0)} times, expected "
             f"{want} ({STATE_PER_LAYER} a layer, {_state_passes(eng)} passes)")
    return want


def state_way(api, params, prompts, graphs, depth, n_time=6, label="phase 18",
              counts_ok=None):
    """Phase 4's workload through StatePagedEngine in one way: served to
    completion (outcome, live tree and state pool bytes, B1 launches —
    ``counts_ok(eng, counts, what)`` checks them, phase 18's count by
    default —, captures), then served again by the warmed engine, which
    must capture nothing new: the first step admits the 8 prompts,
    ``n_time`` steady ticks (8 rows, none at a page boundary) are timed on
    the host clock and 3 more profiled."""
    import torch

    from repro_torch.kernels import build

    phase, label = label, _way_name(graphs, depth)
    eng = state_engine(api, params, graphs, depth)
    _state_submit(eng, prompts)
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = build.counts()
    (counts_ok or _state_counts_ok)(eng, counts, label)
    out, bits = _state_outcome(eng), _state_bits(eng)
    captures = eng.trace_counts()["decode"]
    if graphs and captures != 2:
        fail(f"{phase} [{label}]: {captures} decode captures, expected 2 (with and without "
             "the checkpoint scatter)")
    # tick t ≥ 2 launches a row at position plen + t - 1: a checkpoint tick
    # where that is 15 mod 16; the timed and profiled ticks have none
    if any((len(p) + k) % STATE_PS == STATE_PS - 1 for p in prompts for k in range(1, n_time + 4)):
        fail(f"{phase} [{label}]: a timed steady tick would checkpoint")
    _state_submit(eng, prompts)
    eng.step()  # eight prefills and the first decode launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_time):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_time * 1e3
    prof = _steady_profile(eng, phase, len(prompts))
    host = _host_launches(eng, phase, len(prompts))
    if graphs and host[:2] != (0, 1):
        fail(f"{phase} [{label}]: a steady tick issued {host} (eager kernel launches, graph "
             "replays, ops) from the host")
    eng.run_to_completion()
    torch.cuda.synchronize()
    if eng.trace_counts()["decode"] != captures:
        fail(f"{phase} [{label}]: the warmed engine captured again")
    st = eng.stats
    print(f"{phase} [{label}] phase 4's workload: run {run_s:.2f} s ({out[1]['decode_ticks']} "
          f"decode ticks, {out[1]['prefill_launches']} prefills, "
          f"{out[2]['state_checkpoints']} checkpoints); steady tick (8 rows, {n_time} ticks): "
          f"wall {wall:.2f} ms/tick, {_profile_txt(prof, wall)}; {_host_txt(host)}", flush=True)
    nodes = {k: eng._graphs.node_count(k) for k in eng._graphs.buckets} if graphs else {}
    return {"out": out, "bits": bits, "counts": counts, "wall": wall, "prof": prof,
            "host": host, "nodes": nodes, "engine": eng,
            "prefill_tok_s": st["prefill_tokens"] / max(st["t_prefill_s"], 1e-9)}


def hold_b1(run, label):
    """Run ``run()`` with every B1 launch held to its plain version on the
    launch's own inputs (rtol LINEAR_TOL, atol LINEAR_TOL · max|plain|).
    Returns (what ``run`` returned, launches held by (M, K, N), worst
    max|err|)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fused_linear_ref

    real = ops.bcq_linear
    shapes, worst = {}, [0.0]

    def dense(x, w_idx, w_sel, w_inv, cb, s_x, cfg):
        out = real(x, w_idx, w_sel, w_inv, cb, s_x, cfg)
        ref = fused_linear_ref(x, w_idx, w_sel, w_inv, cb, cfg, s_x, valid_k=x.shape[1])
        ok, err = held(out, ref, LINEAR_TOL, LINEAR_TOL * float(ref.abs().max()))
        key = (x.shape[0], x.shape[1], w_idx.shape[0])
        if not ok:
            fail(f"{label}: a B1 launch at (M, K, N) = {key} disagrees with its plain version "
                 f"on its own inputs: max|err| {err:.3e}")
        shapes[key] = shapes.get(key, 0) + 1
        worst[0] = max(worst[0], err)
        return out

    ops.bcq_linear = dense
    try:
        got = run()
    finally:
        ops.bcq_linear = real
    return got, shapes, worst[0]


def _state_n_in(cfg):
    """in_proj's N: z and x (2 · d_inner), B and C (2 · d_state), dt (heads)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return 2 * d_inner + 2 * cfg.ssm.d_state + d_inner // cfg.ssm.head_dim


def state_launch_checks(api, params, prompts):
    """Every B1 launch of the first engine step (the eight exact-length
    prefills and a decode tick), of a steady tick without a checkpoint and
    of one with its scatter, held to plain (eager depth 1: a wrapper must
    see each launch).  Returns (launches held, worst max|err|)."""
    L = api.cfg.n_layers
    eng = state_engine(api, params, False, 1)
    _state_submit(eng, prompts)
    _, first, e1 = hold_b1(eng.step, "phase 18 first step")
    _, steady, e2 = hold_b1(eng.step, "phase 18 steady tick")
    while not any((s.pos + 1) % STATE_PS == 0 for s in eng.slots if s.req is not None):
        eng.step()
    ck0 = eng.health()["state_counters"]["state_checkpoints"]
    _, ckpt, e3 = hold_b1(eng.step, "phase 18 checkpoint tick")
    n_ck = eng.health()["state_counters"]["state_checkpoints"] - ck0
    eng.run_to_completion()
    want_first = STATE_PER_LAYER * L * (len(prompts) + 1)
    for name, got, want in (("first step", first, want_first),
                            ("steady tick", steady, STATE_PER_LAYER * L),
                            ("checkpoint tick", ckpt, STATE_PER_LAYER * L)):
        if sum(got.values()) != want:
            fail(f"phase 18: {sum(got.values())} B1 launches held in the {name}, expected {want}")
    d, n_in = api.cfg.d_model, _state_n_in(api.cfg)
    if (8, d, n_in) not in steady or (8, 2 * d, d) not in steady \
            or (max(PROMPT_LENS), d, n_in) not in first:
        fail(f"phase 18: the held launches' shapes {sorted(first)} / {sorted(steady)} miss "
             f"in_proj {d} → {n_in} or out_proj {2 * d} → {d}")
    worst = max(e1, e2, e3)
    n = sum(first.values()) + sum(steady.values()) + sum(ckpt.values())
    print(f"phase 18 every B1 launch of the first step (8 prefills of 48–500 tokens + a decode "
          f"tick: {sum(first.values())}), a steady tick ({sum(steady.values())}) and a "
          f"checkpoint tick ({sum(ckpt.values())}, {n_ck} rows checkpointing) vs plain on its "
          f"own inputs: {n} launches at (M, K, N) {sorted(set(first) | set(steady))}, max|err| "
          f"{worst:.3e} (rtol={LINEAR_TOL}, atol={LINEAR_TOL}·max|plain|)", flush=True)
    return n, worst


def state_logits(cfg, prompts, n_layers=STATE_LOGIT_LAYERS, label="phase 18", hold=True):
    """Kernels vs plain logits on identical inputs at ``n_layers`` layers
    of the full width (seeded weights packed to W4) — the
    exact-length prefill of the shortest and the longest prompt, then one
    8-row decode launch over the live tree — and the noise floor: the
    plain path against itself with the embedding scaled by 1 + 2^-22 (one
    ulp).  At full depth a 1-ulp change flips W4A4 encodings that cascade
    through the layers (the floor is then as large as the logits, and the
    comparison says nothing), so the floor must stay below
    ``STATE_FLOOR_FRAC`` of max|logit|, and the kernel path within
    ``max(2 · floor, STATE_LOGIT_RTOL · max|logit|)`` of the plain path;
    ``hold=False`` prints the two comparisons and holds neither.  Returns
    the two comparisons."""
    import dataclasses

    import torch

    from repro_torch.launch.serve import build_model
    from repro_torch.models import zoo
    from repro_torch.serving.pages import state_batch_axes, state_insert_row

    cut = dataclasses.replace(cfg, n_layers=n_layers)
    api_k, params = build_model(cut, "bcq4", True, "cuda", 0, True)
    api_p = zoo.build(cut, dataclasses.replace(api_k.rt, fused_linear=False), device="cuda")
    axes = state_batch_axes(lambda b: api_k.live_cache_init(b, device="meta"))

    def logits(api, p):
        rows, dev = [], api.device
        live = api.live_cache_init(len(prompts))
        for i, pr in enumerate(prompts):
            tokens = torch.tensor(pr, dtype=torch.int32, device=dev)[None]
            lg, one = api.prefill_fn(p, {"tokens": tokens}, STATE_MAX_LEN)
            state_insert_row(live, one, axes, i)
            if i in (0, len(prompts) - 1):
                rows.append(lg[0, -1].float())
        tok = torch.tensor([[int(pr[-1])] for pr in prompts], dtype=torch.int32, device=dev)
        pos = torch.tensor([len(pr) for pr in prompts], dtype=torch.int32, device=dev)
        ld, _ = api.state_decode_fn(p, live, tok, pos)
        return torch.cat([torch.stack(rows), ld[:, -1].float()])

    tag = f"{label} at {n_layers} layers"
    kp = _compare(f"{tag} kernels vs plain, W4A4", logits(api_k, params), logits(api_p, params))
    nudged = dict(params, embed={"kernel": params["embed"]["kernel"] * (1 + 2**-22)})
    floor = _compare(f"{tag} plain vs plain with a 1-ulp embedding nudge (noise floor)",
                     logits(api_p, nudged), logits(api_p, params))
    if not hold:
        return kp, floor
    if floor["max"] > STATE_FLOOR_FRAC * floor["scale"]:
        fail(f"{tag}: the noise floor {floor['max']:.3e} exceeds {STATE_FLOOR_FRAC} of "
             f"max|logit| {floor['scale']:.3f}: the kernels vs plain comparison would say nothing")
    tol = max(2 * floor["max"], STATE_LOGIT_RTOL * floor["scale"])
    if kp["max"] > tol:
        fail(f"{tag}: the kernel path differs from the plain path by {kp['max']:.3e}, beyond "
             f"{tol:.3e} = max(2 · floor, {STATE_LOGIT_RTOL} · max|logit|)")
    print(f"{tag}: kernels vs plain max|Δ| {kp['max']:.3e} within {tol:.3e}; noise floor "
          f"{floor['max']:.3e} ≤ {STATE_FLOOR_FRAC} · max|logit| {floor['scale']:.3f}", flush=True)
    return kp, floor


def _timed_admits(eng):
    """Wrap the engine's ``_try_admit`` with a synchronized host clock: a
    list of (rid, ms) that the wrapper fills."""
    import torch

    real, log = eng._try_admit, []

    def admit(req, slot_idx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = real(req, slot_idx)
        torch.cuda.synchronize()
        if ok:
            log.append((int(req.rid), (time.perf_counter() - t0) * 1e3))
        return ok

    eng._try_admit = admit
    return log


def state_preempted(api, params, prompts, host_pages=0, graphs=False, depth=1, label="phase 18"):
    """Phase 4's workload with request 7 (the youngest, 500 prompt tokens)
    preempted after ``STATE_PREEMPT_AT`` ticks and resumed.  Returns (the
    engine, its outcome, the resumed request's admission ms; a held run's
    admission includes the plain versions' time)."""
    import torch

    eng = state_engine(api, params, graphs, depth, host_pages=host_pages)
    _state_submit(eng, prompts)
    for _ in range(STATE_PREEMPT_AT):
        eng.step()
    if eng._preempt_one(None) != len(prompts) - 1:
        fail(f"{label}: the preemption did not take request 7")
    log = _timed_admits(eng)
    eng.run_to_completion()
    torch.cuda.synchronize()
    admits = [ms for rid, ms in log if rid == len(prompts) - 1]
    if len(admits) != 1:
        fail(f"{label}: request 7 readmitted {len(admits)} times")
    return eng, _state_outcome(eng), admits[0]


def time_state_swap(eng, label="phase 18"):
    """One state page out to the host tier and back, timed: the device
    gather + one transfer + wait (fetch), the host copy + blake2b digest
    (put), the digest check (take), one transfer + the in-place scatter
    (insert), each the mean of 5; the bytes back equal.  Returns the
    numbers."""
    import torch

    from repro_torch.serving.pages import HostPageTier, KIND_STATE

    pid = 1
    tier = HostPageTier(2)
    ms = {"fetch": [], "put": [], "take": [], "insert": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays = eng._fetch_page_arrays(pid)
        t1 = time.perf_counter()
        h = tier.put(arrays, KIND_STATE)
        t2 = time.perf_counter()
        entry = tier.take(h, expect_kind=KIND_STATE)
        t3 = time.perf_counter()
        eng._insert_page_arrays(pid, entry)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, a, b in (("fetch", t0, t1), ("put", t1, t2), ("take", t2, t3), ("insert", t3, t4)):
            ms[k].append((b - a) * 1e3)
    back = eng._fetch_page_arrays(pid)
    if not all(torch.equal(a, b) for a, b in zip(arrays, back)):
        fail(f"{label}: a state page came back from the host tier with other bytes")
    nbytes = sum(a.numel() * a.element_size() for a in arrays)
    return {k: sum(v) / len(v) for k, v in ms.items()} | {"bytes": nbytes}


def state_replay_held(api, params, prompts, timed):
    """The packed checkpoint resume of ``state_preempted`` again, with every
    B1 launch held to plain on its own inputs (``hold_b1``): the batch-1
    replay's launches at M 1 × 768 → 3352 and M 1 × 1536 → 768 (L of each
    a replayed token) and every prefill and decode launch around them.
    The held run's outcome must equal the unheld run's ``timed``
    bit for bit.  Returns (launches held, of them at M 1, worst max|err|)."""
    from repro_torch.kernels import build

    L, d = api.cfg.n_layers, api.cfg.d_model
    build.reset_counts()
    (eng, out, _), shapes, worst = hold_b1(lambda: state_preempted(api, params, prompts),
                                           "phase 18 [packed] checkpoint resume")
    n, replayed = sum(shapes.values()), out[2]["replay_tokens"]
    at_m1 = {k: v for k, v in shapes.items() if k[0] == 1}
    want_m1 = {(1, d, _state_n_in(api.cfg)): L * replayed, (1, 2 * d, d): L * replayed}
    if at_m1 != want_m1:
        fail(f"phase 18 [packed] checkpoint resume: held at M 1 {at_m1}, expected {want_m1} "
             f"({replayed} replayed tokens, {L} layers)")
    if n != STATE_PER_LAYER * L * _state_passes(eng) or build.counts().get("bcq_linear", 0) != n:
        fail(f"phase 18 [packed] checkpoint resume: {n} launches held, "
             f"{build.counts().get('bcq_linear', 0)} counted, expected "
             f"{STATE_PER_LAYER * L * _state_passes(eng)}")
    if out != timed:
        fail("phase 18 [packed] checkpoint resume: the held run's outcome differs from the "
             "unheld run's")
    eng.audit(strict=True)
    return n, sum(at_m1.values()), worst


def phase_state(cb, smi):
    """Phase 18: full-width Mamba2-130m (``mamba2_130m``: ``STATE_LAYERS``
    of its 24 layers, d 768, d_state 128, head_dim 64, vocab 50280; seeded
    random weights packed to
    W4, f32 compute) served in W4A4 through StatePagedEngine on phase 4's
    settings and prompts (8 slots, page 16, 48–500 prompt tokens, 32 new
    tokens): graph depth 2 ≡ eager depth 1 bit for bit (tokens, margins,
    launch indices, counters, live tree and state pool bytes, B1 launch
    counts: 2 a layer and pass); every B1 launch of a first step, a steady
    tick and a checkpoint tick held to plain; kernels vs plain logits
    at ``STATE_LOGIT_LAYERS`` layers (``state_logits``); request 7
    preempted and resumed from its checkpoint (≤ page_size tokens
    replayed: bit-exact at ``quant_mode="none"``; at ``packed`` the run
    again with every B1 launch, the batch-1 replay's too, held to plain,
    and the flips against the never-preempted run counted, which W4A4
    allows: a replay launch has its own ``s_x``) and from the host tier
    (no replay, bit-exact at both); a greedy fork identical, a sampled
    fork reproducible; the chaos smoke at graph depth 2 through
    ``tools/check_chaos.py``.  Prints the
    steady tick, the checkpoint's extra device time, prefill tok/s, a
    state page's swap and the resume times against the full recompute.
    Returns (the phase's B1 launches, its ``kernels`` entry fields, worst
    launch error)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.serve import build_model
    from repro_torch.serving.generate import Request, SamplingParams
    from repro_torch.serving.pages import tree_leaves

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(STATE_ARCH), n_layers=STATE_LAYERS)
    L = cfg.n_layers
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api, params = build_model(cfg, "bcq4", True, "cuda", 0, True)
    torch.cuda.synchronize()
    probe_eng = state_engine(api, params, False, 1)
    page_mb = sum(t[0].numel() * t.element_size() for t in tree_leaves(probe_eng.spool)) / 1e6
    print(f"phase 18 {cfg.name}: {L} layers, d {cfg.d_model}, d_state {cfg.ssm.d_state}, "
          f"head_dim {cfg.ssm.head_dim}, vocab {cfg.vocab}: drawn and packed in "
          f"{time.perf_counter() - t0:.1f} s; a state page {page_mb:.2f} MB, "
          f"{probe_eng.pool_mgr.n_pages} pages; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated", flush=True)
    del probe_eng
    launches = 0

    # the production tick: graph depth 2 ≡ eager depth 1, bit for bit
    ways = [(_way_name(g, d), state_way(api, params, prompts, g, d)) for g, d in
            ((True, 2), (False, 1))]
    (n_g, g2), (n_e, e1) = ways
    for part in ("out", "counts"):
        if g2[part] != e1[part]:
            fail(f"phase 18: {n_g} and {n_e} differ in their {part}")
    if not all(torch.equal(a, b) for a, b in zip(g2["bits"], e1["bits"])):
        fail(f"phase 18: {n_g} and {n_e} leave different live-tree or state-pool bytes")
    launches += 2 * g2["counts"]["bcq_linear"]
    eng = g2["engine"]
    by = _device_kernels(lambda: eng._graphs.run(False), 3)
    by_ck = _device_kernels(lambda: eng._graphs.run(True), 3)
    b1 = lambda got: None if got is None else sum(  # noqa: E731
        ms for nm, ms in got[2].items() if "encode_kernel" in nm or "gemm_" in nm)
    replay_ms = None if by is None else by[1]
    extra = None if by is None or by_ck is None else by_ck[1] - by[1]
    fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"  # noqa: E731
    print(f"phase 18 {cfg.name}: graph depth 2 ≡ eager depth 1 bit for bit (tokens, margins, "
          f"launch indices, counters, live tree and state pool bytes, "
          f"{g2['counts'].get('bcq_linear', 0)} B1 launches: "
          f"{STATE_PER_LAYER} a layer and pass); decode graph nodes {g2['nodes']} (False: "
          f"no checkpoint, True: with the scatter); steady tick wall {g2['wall']:.2f} ms at graph "
          f"depth 2, {e1['wall']:.2f} ms eager depth 1; one graph replay's device time "
          f"{fmt(replay_ms)}, of it B1 ({STATE_PER_LAYER * L} launches) {fmt(b1(by))}; the "
          f"checkpoint variant's extra device time {fmt(extra)}; prefill "
          f"{g2['prefill_tok_s']:.0f} tok/s (exact-length, one prompt a launch); {smi}",
          flush=True)
    for _, w in ways:
        w.pop("engine")
    del eng, ways

    n_held, worst = state_launch_checks(api, params, prompts)
    state_logits(cfg, prompts)

    # preemption and resume: from the checkpoint, then from the host tier
    api_f, params_f = build_model(cfg, "bcq4", False, "cuda", 0, True)
    res = {}
    for mode, (a, p) in (("none", (api_f, params_f)), ("packed", (api, params))):
        base = state_engine(a, p, False, 1)
        _state_submit(base, prompts)
        base.run_to_completion()
        build.reset_counts()
        ck, ck_out, ck_ms = state_preempted(a, p, prompts)
        launches += build.counts().get("bcq_linear", 0)
        build.reset_counts()
        ho, ho_out, ho_ms = state_preempted(a, p, prompts, host_pages=STATE_HOST_PAGES)
        launches += build.counts().get("bcq_linear", 0)
        res[mode] = (_state_outcome(base)[0], ck, ck_out, ck_ms, ho, ho_out, ho_ms)
        del base
    n_rep, n_rep_m1, err_rep = state_replay_held(api, params, prompts, res["packed"][2])
    worst = max(worst, err_rep)
    # the full recompute of request 7's resumed prompt, for comparison
    resumed = [r for r in res["packed"][1].finished if r.rid == len(prompts) - 1][0].prompt
    recompute = state_engine(api, params, False, 1)
    log = _timed_admits(recompute)
    recompute.submit(Request(rid=0, prompt=resumed, max_new=0))
    recompute.run_to_completion()
    rec_ms = log[0][1]
    for mode, (base, ck, ck_out, ck_ms, ho, ho_out, ho_ms) in res.items():
        cs, sw = ck_out[2], ho_out[3]
        if not (0 < cs["replay_tokens"] <= STATE_PS and cs["state_restores"] == 1):
            fail(f"phase 18 [{mode}]: checkpoint resume replayed {cs['replay_tokens']} tokens "
                 f"({cs['state_restores']} restores), expected 1..{STATE_PS}")
        if ho_out[2]["replay_tokens"] or sw["verified_swapins"] != 1 or sw["swap_outs"] != 1:
            fail(f"phase 18 [{mode}]: host resume {ho_out[2]}, swap {sw}")
        if ho_out[0] != base:
            fail(f"phase 18 [{mode}]: the host-tier resume is not bit-exact to the "
                 "never-preempted run")
        for e in (ck, ho):
            e.audit(strict=True)
        toks = {k: v[0] for k, v in ck_out[0].items()}
        flips = sum(x != y for k in base for x, y in zip(base[k][0], toks[k]))
        margins_equal = all(base[k][1] == ck_out[0][k][1] for k in base)
        if mode == "none" and toks != {k: v[0] for k, v in base.items()}:
            fail("phase 18 [none]: the checkpoint resume's tokens differ from the "
                 "never-preempted run's")
        print(f"phase 18 [{mode}] request 7 preempted after {STATE_PREEMPT_AT} ticks: checkpoint "
              f"resume replayed {cs['replay_tokens']} tokens ({cs['replay_tokens'] - 1} state "
              f"tokens recomputed past the checkpoint, ≤ {STATE_PS - 1}) in {ck_ms:.2f} ms, "
              f"tokens vs the never-preempted run: {flips} of "
              f"{sum(len(v[0]) for v in base.values())} differ (margins bit-equal: "
              f"{margins_equal}); host-tier resume 0 replayed in "
              f"{ho_ms:.2f} ms (swap {sw['swap_bytes']} B out and in), bit-exact; audits clean",
              flush=True)
    pk = res["packed"][1]
    print(f"phase 18 [packed] checkpoint resume again with every B1 launch held to plain on its "
          f"own inputs: {n_rep} launches, {n_rep_m1} of them the batch-1 replay's at (M, K, N) "
          f"(1, {cfg.d_model}, {_state_n_in(cfg)}) and (1, {2 * cfg.d_model}, {cfg.d_model}), max|err| "
          f"{err_rep:.3e} (rtol={LINEAR_TOL}, atol={LINEAR_TOL}·max|plain|), outcome bit-equal to "
          f"the unheld run; full recompute of the {len(resumed)}-token resumed prompt "
          f"{rec_ms:.2f} ms vs checkpoint {res['packed'][3]:.2f} ms vs host tier "
          f"{res['packed'][6]:.2f} ms (unheld runs)", flush=True)
    swap = time_state_swap(pk)
    print(f"phase 18 one state page ({swap['bytes']} B) through the host tier: fetch (device "
          f"gather + one transfer + wait) {swap['fetch']:.3f} ms, put (host copy + blake2b) "
          f"{swap['put']:.3f} ms, take (blake2b check) {swap['take']:.3f} ms, insert (one "
          f"transfer + in-place scatter, synced) {swap['insert']:.3f} ms; PCIe Gen5 x16 bound "
          f"{swap['bytes'] / PCIE_BPS * 1e3:.3f} ms each way", flush=True)
    del res, pk, ck, ho, recompute, api_f, params_f

    # forks: greedy identical, sampled reproducible
    build.reset_counts()
    sp = SamplingParams(temperature=0.8, top_k=40, seed=1234)
    outs = []
    for _ in range(2):
        e = state_engine(api, params, True, 2)
        e.submit(Request(rid=0, prompt=prompts[0], max_new=GEN - 1, n_samples=2))
        e.submit(Request(rid=1, prompt=prompts[1], max_new=GEN - 1, n_samples=3, sampling=sp))
        e.run_to_completion()
        e.audit(strict=True)
        outs.append({(r.rid, r.sample_idx): r.out for r in e.finished})
    launches += build.counts().get("bcq_linear", 0)
    if outs[0] != outs[1] or outs[0][(0, 0)] != outs[0][(0, 1)] \
            or len({tuple(outs[0][(1, k)]) for k in range(3)}) < 2:
        fail(f"phase 18: forks: greedy siblings equal {outs[0][(0, 0)] == outs[0][(0, 1)]}, "
             f"sampled reproducible {outs[0] == outs[1]}")
    print("phase 18 forks (graph depth 2): greedy siblings identical, a sampled fork of 3 "
          "reproducible and divergent", flush=True)

    # the chaos smoke at graph depth 2
    path = os.path.join(ROOT, "build", "chaos_state.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    build.reset_counts()
    rep = serve.run_chaos(api, params, prompts[:4], 16, page_size=STATE_PS, report_path=path,
                          arch=cfg.name, host_pages=STATE_HOST_PAGES)
    launches += build.counts().get("bcq_linear", 0)
    check = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "check_chaos.py"), path],
                           capture_output=True, text=True, timeout=120)
    sw = rep["health"]["swap"]
    print(f"phase 18 tools/check_chaos.py (exit {check.returncode}): "
          f"{(check.stdout + check.stderr).strip()}; host tier: {sw['swap_outs']} swap-outs, "
          f"{sw['swap_ins']} swap-ins (nothing in this schedule preempts a state slot, so the "
          f"tier's faults are not exercised here)", flush=True)
    if check.returncode or rep["page_layout"] != "state" or not rep["final_audit"]["ok"]:
        fail("phase 18: the state-layout chaos report fails tools/check_chaos.py")
    torch.cuda.empty_cache()
    entry = {"at_ssm_decode": dict(_linear_times(cb, 8, cfg.d_model, 3352, 95),
                                   shape=f"M 8 K {cfg.d_model} N 3352 (mamba2_130m in_proj)"),
             "at_ssm_prefill": dict(_linear_times(cb, max(PROMPT_LENS), cfg.d_model, 3352, 94),
                                    shape=f"M {max(PROMPT_LENS)} K {cfg.d_model} N 3352")}
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, entry, worst


# ------------------------------------------------------------------ phase 19
HYB_ARCH = "recurrentgemma_9b"
HYB_LAYERS = 5  # of its 38: 1 of 12 periods + the 2 tail blocks, for the script's time
# B1 launches a block and pass: a recurrent block's proj_x, proj_gate,
# gate_a, gate_x, proj_out and MLP wi, wo; an attention block's wq, wk,
# wv, wo and MLP at decode, and wk, wv again to fill the ring at prefill
HYB_REC, HYB_ATTN_DECODE, HYB_ATTN_PREFILL = 7, 6, 8
HYB_RING_LENS = (2040, 2100)  # (b): past the 2048-token window in decode, and at prefill
HYB_RING_NEW = 40
HYB_RING_MAX_LEN = 2144
# kernels vs plain logits: one RG-LRU block at the full width is held.  A
# local-attention block alone, 2 layers and the 5-layer stack (1 period + 2
# tail blocks, the full config's shape of stack) are printed, not held:
# there a 1-ulp nudge of the embedding, or B1's f32 sum order (1e-5 of a
# launch's output), flips W4A4 encodings downstream, and the comparison
# says nothing
HYB_LOGIT_LAYERS = 5
HYB_CHAOS = {"seed": 3, "rate": 0.2, "audit_every": 1, "deadline_s": 30.0}  # the CI hot run
HYB_CHAOS_GEN = 8


def _hyb_per_pass(cfg, prefill: bool) -> int:
    """B1 launches of one pass of the layer stack (a prompt of more than
    one token takes the attention blocks' prefill branch)."""
    n_attn = cfg.hybrid.pattern.count("attn") * (cfg.n_layers // len(cfg.hybrid.pattern))
    return HYB_REC * (cfg.n_layers - n_attn) + (
        HYB_ATTN_PREFILL if prefill else HYB_ATTN_DECODE) * n_attn


def _hybrid_counts_ok(eng, counts, label):
    """B1's launches of a run: a prefill pass per exact-length prefill, a
    decode pass per tick and per replayed token."""
    cfg = eng.api.cfg
    st, cs = eng.stats, eng.health()["state_counters"]
    prefills = st["prefill_launches"] - cs["state_restores"]
    passes = st["decode_ticks"] + cs["replay_tokens"]
    want = _hyb_per_pass(cfg, True) * prefills + _hyb_per_pass(cfg, False) * passes
    if counts.get("bcq_linear", 0) != want:
        fail(f"phase 19 [{label}]: B1 launched {counts.get('bcq_linear', 0)} times, expected "
             f"{want} ({prefills} prefill passes × {_hyb_per_pass(cfg, True)}, {passes} decode "
             f"passes × {_hyb_per_pass(cfg, False)})")
    return want


def ring_engine(api, params, graphs, depth):
    """Workload (b)'s engine: a slot a request, page 16, max_len 2144."""
    from repro_torch.serving.state_engine import StatePagedEngine

    return StatePagedEngine(api, params, n_slots=len(HYB_RING_LENS), max_len=HYB_RING_MAX_LEN,
                            page_size=STATE_PS, device="cuda", pipeline_depth=depth,
                            cuda_graphs=graphs)


def ring_way(api, params, prompts, graphs, depth):
    """Workload (b) served to completion in one way: outcome, live tree and
    state pool bytes, B1 launches, prefill tok/s."""
    import torch

    from repro_torch.kernels import build

    label = f"ring run, {_way_name(graphs, depth)}"
    eng = ring_engine(api, params, graphs, depth)
    _state_submit(eng, prompts, max_new=HYB_RING_NEW - 1)
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = build.counts()
    _hybrid_counts_ok(eng, counts, label)
    out = _state_outcome(eng)
    if any(len(v[0]) != HYB_RING_NEW for v in out[0].values()):
        fail(f"phase 19 [{label}]: {[len(v[0]) for v in out[0].values()]} tokens, expected "
             f"{HYB_RING_NEW} each")
    st = eng.stats
    return {"out": out, "bits": _state_bits(eng), "counts": counts, "run_s": run_s,
            "prefill_tok_s": st["prefill_tokens"] / max(st["t_prefill_s"], 1e-9),
            "ticks": st["decode_ticks"]}


def hybrid_launch_checks(api, params, prompts, ring_prompts):
    """Every B1 launch of (a)'s first engine step (8 exact-length prefills
    and a decode tick), of a steady tick without a checkpoint, of one with
    its scatter, and of (b)'s first step (the prefills at M 2040 and 2100,
    a 2-row tick) held to plain on its own inputs (eager depth 1).  The
    counts and the new shapes are asserted.  Returns (launches held,
    worst max|err|, the shapes held)."""
    cfg = api.cfg
    pre, dec = _hyb_per_pass(cfg, True), _hyb_per_pass(cfg, False)
    eng = state_engine(api, params, False, 1)
    _state_submit(eng, prompts)
    _, first, e1 = hold_b1(eng.step, "phase 19 first step")
    _, steady, e2 = hold_b1(eng.step, "phase 19 steady tick")
    while not any((s.pos + 1) % STATE_PS == 0 for s in eng.slots if s.req is not None):
        eng.step()
    ck0 = eng.health()["state_counters"]["state_checkpoints"]
    _, ckpt, e3 = hold_b1(eng.step, "phase 19 checkpoint tick")
    n_ck = eng.health()["state_counters"]["state_checkpoints"] - ck0
    eng.run_to_completion()
    del eng
    ring = ring_engine(api, params, False, 1)
    _state_submit(ring, ring_prompts, max_new=HYB_RING_NEW - 1)
    _, rfirst, e4 = hold_b1(ring.step, "phase 19 ring run's first step")
    ring.run_to_completion()
    del ring
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim
    for name, got, want in (("first step", first, len(prompts) * pre + dec),
                            ("steady tick", steady, dec), ("checkpoint tick", ckpt, dec),
                            ("ring run's first step", rfirst, len(ring_prompts) * pre + dec)):
        if sum(got.values()) != want:
            fail(f"phase 19: {sum(got.values())} B1 launches held in the {name}, expected {want}")
    need = {"steady tick": (steady, [(8, f, d), (8, d, kv), (8, d, f), (8, d, d)]),
            "first step": (first, [(max(PROMPT_LENS), f, d), (max(PROMPT_LENS), d, kv)]),
            "ring run's first step": (rfirst, [(n, f, d) for n in HYB_RING_LENS]
                                      + [(n, d, kv) for n in HYB_RING_LENS])}
    for name, (got, keys) in need.items():
        if not all(k in got for k in keys):
            fail(f"phase 19: the {name}'s held shapes {sorted(got)} miss {keys}")
    worst = max(e1, e2, e3, e4)
    n = sum(sum(x.values()) for x in (first, steady, ckpt, rfirst))
    shapes = sorted(set(first) | set(steady) | set(rfirst))
    print(f"phase 19 every B1 launch held to plain on its own inputs: (a)'s first step (8 "
          f"prefills of 48–500 tokens × {pre} + a decode tick × {dec} = {sum(first.values())}), "
          f"a steady tick ({sum(steady.values())}), a checkpoint tick ({sum(ckpt.values())}, "
          f"{n_ck} rows checkpointing), (b)'s first step (prefills of {HYB_RING_LENS} tokens "
          f"+ a 2-row tick = {sum(rfirst.values())}): {n} launches at {len(shapes)} (M, K, N) "
          f"shapes, K up to {max(k for _, k, _ in shapes)}; max|err| {worst:.3e} "
          f"(rtol={LINEAR_TOL}, atol={LINEAR_TOL}·max|plain|)", flush=True)
    return n, worst, shapes


def replay_held(eng, per_token, timed, label):
    """Serve ``eng`` — its request 7 preempted after ``STATE_PREEMPT_AT``
    ticks — to the end with every B1 launch of the batch-1 checkpoint
    replay (eager, M 1, ``per_token`` launches a replayed token) held to
    plain on its own inputs; the outcome must equal the unheld run's
    ``timed`` bit for bit.  Returns (launches held, worst max|err|)."""
    import torch

    real, held_log = eng._replay, []

    def replay(*a):
        got, shapes, err = hold_b1(lambda: real(*a), f"{label} checkpoint replay")
        held_log.append((shapes, err))
        return got

    eng._replay = replay
    eng.run_to_completion()
    torch.cuda.synchronize()
    out = _state_outcome(eng)
    replayed = out[2]["replay_tokens"]
    if len(held_log) != 1:
        fail(f"{label}: {len(held_log)} replays held, expected 1")
    shapes, err = held_log[0]
    if {k[0] for k in shapes} != {1} or sum(shapes.values()) != per_token * replayed:
        fail(f"{label} checkpoint replay: held {shapes}, expected {per_token} × {replayed} "
             "launches at M 1")
    if out != timed:
        fail(f"{label} checkpoint resume: the held run's outcome differs from the unheld run's")
    eng.audit(strict=True)
    return sum(shapes.values()), err


def hybrid_replay_held(api, params, prompts, timed):
    """The packed checkpoint resume of ``state_preempted`` again (graph
    depth 2), every replay launch held (``replay_held``)."""
    eng = state_engine(api, params, True, 2)
    _state_submit(eng, prompts)
    for _ in range(STATE_PREEMPT_AT):
        eng.step()
    if eng._preempt_one(None) != len(prompts) - 1:
        fail("phase 19: the preemption did not take request 7")
    return replay_held(eng, _hyb_per_pass(api.cfg, False), timed, "phase 19 [packed]")


def _hybrid_resumes(mode, base, ck_out, ck_ms, ho_out, ho_ms):
    """Check and print request 7's two resumes against the never-preempted
    run ``base``: the checkpoint one replayed 1..page_size tokens (its
    tokens equal at ``none``, the flips counted at ``packed``), the host
    tier's none and bit-exact."""
    cs, sw = ck_out[2], ho_out[3]
    if not (0 < cs["replay_tokens"] <= STATE_PS and cs["state_restores"] == 1):
        fail(f"phase 19 [{mode}]: checkpoint resume replayed {cs['replay_tokens']} tokens "
             f"({cs['state_restores']} restores), expected 1..{STATE_PS}")
    if ho_out[2]["replay_tokens"] or sw["verified_swapins"] != 1 or sw["swap_outs"] != 1:
        fail(f"phase 19 [{mode}]: host resume {ho_out[2]}, swap {sw}")
    if ho_out[0] != base:
        fail(f"phase 19 [{mode}]: the host-tier resume is not bit-exact to the never-preempted "
             "run")
    toks = {k: v[0] for k, v in ck_out[0].items()}
    flips = sum(x != y for k in base for x, y in zip(base[k][0], toks[k]))
    if mode == "none" and toks != {k: v[0] for k, v in base.items()}:
        fail("phase 19 [none]: the checkpoint resume's tokens differ from the never-preempted "
             "run's")
    print(f"phase 19 [{mode}] request 7 preempted after {STATE_PREEMPT_AT} ticks: checkpoint "
          f"resume replayed {cs['replay_tokens']} tokens ({cs['replay_tokens'] - 1} state tokens "
          f"recomputed past the checkpoint, ≤ {STATE_PS - 1}) in {ck_ms:.2f} ms, tokens vs the "
          f"never-preempted run: {flips} of {sum(len(v[0]) for v in base.values())} differ; "
          f"host-tier resume 0 replayed in {ho_ms:.2f} ms (swap {sw['swap_bytes']} B out and in), "
          "bit-exact; audits clean", flush=True)


def phase_hybrid(cb, smi):
    """Phase 19: full-width RecurrentGemma-9B (``recurrentgemma_9b``:
    ``HYB_LAYERS`` of its 38 layers = periods (rec, rec, attn) + 2 tail rec
    blocks, d 4096, 16
    heads of 256 and 1 KV head, d_ff 12288, lru_width 4096, window 2048,
    vocab 256000, untied; seeded random weights drawn and packed to W4 a
    period and a tail block at a time on the card, a bcq4 ring, f32
    compute) served in W4A4 through StatePagedEngine: (a) phase 4's
    settings and prompts, (b) two requests of 2,040 and 2,100 tokens for
    40 tokens each (max_len 2,144: past the window in decode, and at
    prefill); graph depth 2 ≡ eager depth 1 bit for bit on both; every B1
    launch of (a)'s first step, a steady tick, a checkpoint tick and (b)'s
    first step held to plain, counts and shapes asserted; kernels vs plain
    logits of one RG-LRU block at the full width (its noise floor under
    1e-3 of max|logit|; one local-attention block, 2 layers and the 5-layer
    stack printed, not held); request 7 of (a) preempted after 20 ticks and resumed from
    its checkpoint (≤ 16 tokens replayed, every replay launch held at
    ``packed``; tokens equal at ``quant_mode="none"``, flips counted at
    ``packed``) and from the host tier (no replay, bit-exact at both);
    greedy and sampled forks; the reference CI's hot state-layout chaos
    run through ``tools/check_chaos.py``.  Prints the init, the steady
    tick, the checkpoint's extra device time, prefill tok/s, a state
    page's swap and the resume times.  Returns (the phase's B1 launches,
    its ``kernels`` entry fields, worst launch error)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.serve import build_model
    from repro_torch.serving.generate import Request, SamplingParams
    from repro_torch.serving.pages import REPLICATED, tree_leaves

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(HYB_ARCH), n_layers=HYB_LAYERS)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    ring_prompts = [rng.integers(0, cfg.vocab, n) for n in HYB_RING_LENS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    api, params = build_model(cfg, "bcq4", True, "cuda", 0, True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = (torch.cuda.memory_allocated() - before) / 1e9
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    probe = state_engine(api, params, False, 1)
    page_b = sum(t[0].numel() * t.element_size() for t, ax in
                 zip(tree_leaves(probe.spool), tree_leaves(probe.axes)) if ax != REPLICATED)
    period = len(cfg.hybrid.pattern)
    print(f"phase 19 {cfg.name}: {cfg.n_layers} layers ({cfg.n_layers // period} periods "
          f"{', '.join(cfg.hybrid.pattern)} + {cfg.n_layers % period} tail), "
          f"d {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, {cfg.n_kv_heads} KV head, "
          f"d_ff {cfg.d_ff}, window {cfg.hybrid.window}, vocab {cfg.vocab}: drawn and packed a "
          f"period at a time in {init_s:.1f} s; the model {resident:.2f} GB resident (peak "
          f"{peak:.2f} GB during the init, over what earlier phases hold); a state page {page_b} B ({page_b / 1e6:.2f} MB), "
          f"{probe.pool_mgr.n_pages} pages", flush=True)
    del probe
    launches = 0

    # the production tick on (a) and (b): graph depth 2 ≡ eager depth 1
    ways = [(_way_name(g, d), state_way(api, params, prompts, g, d, label="phase 19",
                                        counts_ok=_hybrid_counts_ok))
            for g, d in ((True, 2), (False, 1))]
    (n_g, g2), (n_e, e1) = ways
    for part in ("out", "counts"):
        if g2[part] != e1[part]:
            fail(f"phase 19: {n_g} and {n_e} differ in their {part}")
    if not all(torch.equal(a, b) for a, b in zip(g2["bits"], e1["bits"])):
        fail(f"phase 19: {n_g} and {n_e} leave different live-tree or state-pool bytes")
    launches += 2 * g2["counts"]["bcq_linear"]
    eng = g2["engine"]
    by = _device_kernels(lambda: eng._graphs.run(False), 3)
    by_ck = _device_kernels(lambda: eng._graphs.run(True), 3)
    b1 = lambda got: None if got is None else sum(  # noqa: E731
        ms for nm, ms in got[2].items() if "encode_kernel" in nm or "gemm_" in nm)
    replay_ms = None if by is None else by[1]
    extra = None if by is None or by_ck is None else by_ck[1] - by[1]
    fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"  # noqa: E731
    dec = _hyb_per_pass(cfg, False)
    print(f"phase 19 (a): graph depth 2 ≡ eager depth 1 bit for bit (tokens, margins, launch "
          f"indices, counters, live tree and state pool bytes, {g2['counts'].get('bcq_linear', 0)} "
          f"B1 launches: {_hyb_per_pass(cfg, True)} a prefill pass, {dec} a decode pass); decode "
          f"graph nodes {g2['nodes']} (False: no checkpoint, True: with the scatter); steady tick "
          f"wall {g2['wall']:.2f} ms at graph depth 2, {e1['wall']:.2f} ms eager depth 1; one "
          f"graph replay's device time {fmt(replay_ms)}, of it B1 ({dec} launches) {fmt(b1(by))}; "
          f"the checkpoint variant's extra device time {fmt(extra)}; prefill "
          f"{g2['prefill_tok_s']:.0f} tok/s (exact-length, one prompt a launch); {smi}",
          flush=True)
    for _, w in ways:
        w.pop("engine")
    del eng, ways
    rings = [(_way_name(g, d), ring_way(api, params, ring_prompts, g, d))
             for g, d in ((True, 2), (False, 1))]
    (_, rg), (_, re_) = rings
    if rg["out"] != re_["out"] or rg["counts"] != re_["counts"] or not all(
            torch.equal(a, b) for a, b in zip(rg["bits"], re_["bits"])):
        fail("phase 19 (b): graph depth 2 and eager depth 1 differ")
    launches += 2 * rg["counts"]["bcq_linear"]
    print(f"phase 19 (b) prompts of {HYB_RING_LENS} tokens, {HYB_RING_NEW} tokens each (the "
          f"first row crosses the {cfg.hybrid.window}-token window while it decodes, the second "
          f"keeps its last {cfg.hybrid.window} tokens at prefill): graph depth 2 ≡ eager depth "
          f"1 bit for bit ({rg['counts']['bcq_linear']} B1 launches, {rg['ticks']} ticks); run "
          f"{rg['run_s']:.2f} s graph depth 2, {re_['run_s']:.2f} s eager; prefill "
          f"{rg['prefill_tok_s']:.0f} tok/s", flush=True)
    del rings

    n_held, worst, shapes = hybrid_launch_checks(api, params, prompts, ring_prompts)

    # preemption and resume at packed: from the checkpoint, then from the host tier
    # (the production tick, graph depth 2: phase 19 held it to eager depth 1 above)
    base = state_engine(api, params, True, 2)
    _state_submit(base, prompts)
    base.run_to_completion()
    base_out = _state_outcome(base)[0]
    del base
    build.reset_counts()
    ck, ck_out, ck_ms = state_preempted(api, params, prompts, graphs=True, depth=2,
                                        label="phase 19")
    launches += build.counts().get("bcq_linear", 0)
    build.reset_counts()
    ho, ho_out, ho_ms = state_preempted(api, params, prompts, host_pages=STATE_HOST_PAGES,
                                        graphs=True, depth=2, label="phase 19")
    launches += build.counts().get("bcq_linear", 0)
    build.reset_counts()
    n_rep, err_rep = hybrid_replay_held(api, params, prompts, ck_out)
    launches += build.counts().get("bcq_linear", 0)
    worst = max(worst, err_rep)
    resumed = [r for r in ck.finished if r.rid == len(prompts) - 1][0].prompt
    recompute = state_engine(api, params, False, 1)
    log = _timed_admits(recompute)
    recompute.submit(Request(rid=0, prompt=resumed, max_new=0))
    recompute.run_to_completion()
    rec_ms = log[0][1]
    swap = time_state_swap(ck, "phase 19")
    for e in (ck, ho):
        e.audit(strict=True)
    del ck, ho, recompute
    _hybrid_resumes("packed", base_out, ck_out, ck_ms, ho_out, ho_ms)
    print(f"phase 19 [packed] checkpoint replay again with its {n_rep} B1 launches (M 1, "
          f"{dec} a replayed token) held to plain on their own inputs: max|err| {err_rep:.3e}, "
          f"outcome bit-equal to the unheld run; full recompute of the {len(resumed)}-token "
          f"resumed prompt {rec_ms:.2f} ms vs checkpoint {ck_ms:.2f} ms vs host tier "
          f"{ho_ms:.2f} ms (unheld runs)", flush=True)
    print(f"phase 19 one state page ({swap['bytes']} B) through the host tier: fetch (device "
          f"gather + one transfer + wait) {swap['fetch']:.3f} ms, put (host copy + blake2b) "
          f"{swap['put']:.3f} ms, take (blake2b check) {swap['take']:.3f} ms, insert (one "
          f"transfer + in-place scatter, synced) {swap['insert']:.3f} ms; PCIe Gen5 x16 bound "
          f"{swap['bytes'] / PCIE_BPS * 1e3:.3f} ms each way", flush=True)

    # forks: greedy identical, sampled reproducible
    build.reset_counts()
    sp = SamplingParams(temperature=0.8, top_k=40, seed=1234)
    outs = []
    for _ in range(2):
        e = state_engine(api, params, True, 2)
        e.submit(Request(rid=0, prompt=prompts[0], max_new=GEN - 1, n_samples=2))
        e.submit(Request(rid=1, prompt=prompts[1], max_new=GEN - 1, n_samples=3, sampling=sp))
        e.run_to_completion()
        e.audit(strict=True)
        outs.append({(r.rid, r.sample_idx): r.out for r in e.finished})
        del e
    launches += build.counts().get("bcq_linear", 0)
    if outs[0] != outs[1] or outs[0][(0, 0)] != outs[0][(0, 1)] \
            or len({tuple(outs[0][(1, k)]) for k in range(3)}) < 2:
        fail(f"phase 19: forks: greedy siblings equal {outs[0][(0, 0)] == outs[0][(0, 1)]}, "
             f"sampled reproducible {outs[0] == outs[1]}")
    print("phase 19 forks (graph depth 2): greedy siblings identical, a sampled fork of 3 "
          "reproducible and divergent", flush=True)

    # the reference CI's hot state-layout chaos run, at graph depth 2
    path = os.path.join(ROOT, "build", "chaos_hybrid.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    build.reset_counts()
    rep = serve.run_chaos(api, params, prompts[:4], HYB_CHAOS_GEN, page_size=STATE_PS,
                          report_path=path, arch=cfg.name, **HYB_CHAOS)
    launches += build.counts().get("bcq_linear", 0)
    check = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "check_chaos.py"), path],
                           capture_output=True, text=True, timeout=120)
    print(f"phase 19 hot chaos run (seed {HYB_CHAOS['seed']}, rate {HYB_CHAOS['rate']}, audit "
          f"every tick, deadline {HYB_CHAOS['deadline_s']} s) tools/check_chaos.py (exit "
          f"{check.returncode}): {(check.stdout + check.stderr).strip()}; faults "
          f"{rep['faults']['by_site']}", flush=True)
    if (check.returncode or rep["page_layout"] != "state" or not rep["final_audit"]["ok"]
            or rep["unhandled_exception"] is not None or rep["leaked_pages"]):
        fail("phase 19: the hot state-layout chaos run is not contained")
    del api, params
    torch.cuda.empty_cache()

    # kernels vs plain logits: one RG-LRU block (the tail block of a 1-layer
    # cut) held; one local-attention block (a period of ``("attn",)``), two
    # RG-LRU blocks and the 5-layer stack printed
    state_logits(cfg, prompts, n_layers=1, label="phase 19 one RG-LRU block")
    attn_only = dataclasses.replace(cfg, hybrid=dataclasses.replace(cfg.hybrid, pattern=("attn",)))
    state_logits(attn_only, prompts, n_layers=1,
                 label="phase 19 one local-attention block (printed, not held)", hold=False)
    for n in (2, HYB_LOGIT_LAYERS):
        state_logits(cfg, prompts, n_layers=n, label="phase 19 (printed, not held)", hold=False)
    torch.cuda.empty_cache()

    # the same preemption at quant_mode="none" (float weights, ~34 GB)
    api_f, params_f = build_model(cfg, "bcq4", False, "cuda", 0, True)
    base = state_engine(api_f, params_f, True, 2)
    _state_submit(base, prompts)
    base.run_to_completion()
    fbase = _state_outcome(base)[0]
    del base
    fck, fck_out, fck_ms = state_preempted(api_f, params_f, prompts, graphs=True, depth=2,
                                           label="phase 19")
    fho, fho_out, fho_ms = state_preempted(api_f, params_f, prompts, host_pages=STATE_HOST_PAGES,
                                           graphs=True, depth=2, label="phase 19")
    for e in (fck, fho):
        e.audit(strict=True)
    del fck, fho, api_f, params_f
    torch.cuda.empty_cache()
    _hybrid_resumes("none", fbase, fck_out, fck_ms, fho_out, fho_ms)
    entry = {"at_hybrid_decode": dict(_linear_times(cb, 8, cfg.d_ff, cfg.d_model, 93),
                                      shape=f"M 8 K {cfg.d_ff} N {cfg.d_model} "
                                            "(recurrentgemma_9b mlp-out)"),
             "at_hybrid_prefill": dict(_linear_times(cb, max(HYB_RING_LENS), cfg.d_ff,
                                                     cfg.d_model, 92),
                                       shape=f"M {max(HYB_RING_LENS)} K {cfg.d_ff} N "
                                             f"{cfg.d_model}")}
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, entry, worst


# ------------------------------------------------------------------ phase 20
ENC_ARCH = "whisper_base"
ENC_MAX_LEN = 448  # Whisper's text context
ENC_SLOTS = 8
ENC_CLIPS = 3  # distinct 30 s clips, 1,500 stub frames each
ENC_PROMPT_LENS = (4, 36, 100, 224)  # decoder prompts: a task prompt up to a long prefix
ENC_REQS = 12  # request i: clip i % ENC_CLIPS, prompt ENC_PROMPT_LENS[i % 4]
ENC_GEN = 48
ENC_EVAL_CLIPS = 4  # the evaluation forward: 4 clips × ENC_MAX_LEN tokens, bf16
# B1 launches: an encode, 6 an encoder layer (q, k, v, o, mlp in, out) and
# 2 a decoder layer (the cross K/V); a decoder pass, 8 a layer (self q, k,
# v, o, cross q, o, mlp in, out)
ENC_PER_ENC_LAYER, ENC_XKV_PER_LAYER, ENC_PER_DEC_LAYER = 6, 2, 8


def _encdec_per_encode(cfg) -> int:
    return ENC_PER_ENC_LAYER * cfg.n_encoder_layers + ENC_XKV_PER_LAYER * cfg.n_layers


def _encdec_counts_ok(eng, counts, label):
    """B1's launches of a run: an encode per encoder launch, a decoder pass
    per exact-length prefill, decode tick and replayed token."""
    cfg = eng.api.cfg
    st, cs = eng.stats, eng.health()["state_counters"]
    passes = (st["prefill_launches"] - cs["state_restores"] + st["decode_ticks"]
              + cs["replay_tokens"])
    want = (_encdec_per_encode(cfg) * cs["encoder_launches"]
            + ENC_PER_DEC_LAYER * cfg.n_layers * passes)
    if counts.get("bcq_linear", 0) != want:
        fail(f"phase 20 [{label}]: B1 launched {counts.get('bcq_linear', 0)} times, expected "
             f"{want} ({cs['encoder_launches']} encodes × {_encdec_per_encode(cfg)}, {passes} "
             f"decoder passes × {ENC_PER_DEC_LAYER * cfg.n_layers})")
    return want


def encdec_inputs(cfg):
    """The phase's clips (``ENC_CLIPS`` stub frame tensors (encoder_len,
    d_model), numpy normals · 0.02) and the 12 requests' decoder prompts."""
    rng = np.random.default_rng(20)
    clips = [(rng.normal(size=(cfg.encoder_len, cfg.d_model)) * 0.02).astype(np.float32)
             for _ in range(ENC_CLIPS)]
    prompts = [rng.integers(0, cfg.vocab, ENC_PROMPT_LENS[i % len(ENC_PROMPT_LENS)])
               for i in range(ENC_REQS)]
    return clips, prompts


def encdec_submit(eng, clips, prompts):
    """Request i: ``prompts[i]`` over clip i % ``len(clips)``, ``ENC_GEN`` tokens."""
    from repro_torch.serving.generate import Request

    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=ENC_GEN - 1, frames=clips[i % len(clips)]))


def encdec_engine(api, params, graphs, depth, **kw):
    """Phase 20's engine: 8 slots, page 16, max_len 448, prefix caching on."""
    from repro_torch.serving.state_engine import StatePagedEngine

    return StatePagedEngine(api, params, n_slots=ENC_SLOTS, max_len=ENC_MAX_LEN,
                            page_size=STATE_PS, device="cuda", pipeline_depth=depth,
                            cuda_graphs=graphs, **kw)


def _encdec_bits(eng):
    return _state_bits(eng) + [t.clone() for t in eng.enc_pool]


def encdec_way(api, params, clips, prompts, graphs, depth, n_time=6):
    """The 12 requests through the engine in one way: served to completion
    (outcome, live tree, state and encoder pool bytes, B1 launches, 3
    encodes and 9 prefix hits, captures), then served again by the warmed
    engine — every clip a hit, nothing captured — whose first step admits
    8 requests, then ``n_time`` steady ticks (8 rows, none checkpointing)
    timed on the host clock, 3 profiled and 3 recorded for their host
    launches."""
    import torch

    from repro_torch.kernels import build

    label = _way_name(graphs, depth)
    cfg = api.cfg
    eng = encdec_engine(api, params, graphs, depth)
    encdec_submit(eng, clips, prompts)
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = build.counts()
    _encdec_counts_ok(eng, counts, label)
    out, bits = _state_outcome(eng), _encdec_bits(eng)
    st = eng.stats
    hits = (ENC_REQS - ENC_CLIPS, (ENC_REQS - ENC_CLIPS) * cfg.encoder_len)
    if out[2]["encoder_launches"] != ENC_CLIPS or (st["prefix_hits"],
                                                   st["prefill_tokens_skipped"]) != hits:
        fail(f"phase 20 [{label}]: {out[2]['encoder_launches']} encodes, {st['prefix_hits']} "
             f"prefix hits skipping {st['prefill_tokens_skipped']} frames; expected "
             f"{ENC_CLIPS} and {hits}")
    if any(len(v[0]) != ENC_GEN for v in out[0].values()):
        fail(f"phase 20 [{label}]: {[len(v[0]) for v in out[0].values()]} tokens, expected "
             f"{ENC_GEN} each")
    captures = eng.trace_counts()["decode"]
    if graphs and captures != 2:
        fail(f"phase 20 [{label}]: {captures} decode captures, expected 2")
    # tick t ≥ 2 of the second run launches row i at position plen_i + t - 1:
    # the timed ticks checkpoint no row
    if any((len(p) + t - 1) % STATE_PS == STATE_PS - 1 for p in prompts[:ENC_SLOTS]
           for t in range(2, n_time + 2)):
        fail(f"phase 20 [{label}]: a timed steady tick would checkpoint")
    pre_tok, pre_s = st["prefill_tokens"], st["t_prefill_s"]
    encdec_submit(eng, clips, prompts)
    eng.step()  # eight prefills on hits and the first decode launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_time):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_time * 1e3
    prof = _steady_profile(eng, "phase 20", ENC_SLOTS)
    host = _host_launches(eng, "phase 20", ENC_SLOTS)
    if graphs and host[:2] != (0, 1):
        fail(f"phase 20 [{label}]: a steady tick issued {host} (eager kernel launches, graph "
             "replays, ops) from the host")
    eng.run_to_completion()
    torch.cuda.synchronize()
    if eng.trace_counts()["decode"] != captures or \
            eng.health()["state_counters"]["encoder_launches"] != ENC_CLIPS:
        fail(f"phase 20 [{label}]: the warmed engine captured or encoded again")
    hit_tok_s = (st["prefill_tokens"] - pre_tok) / max(st["t_prefill_s"] - pre_s, 1e-9)
    print(f"phase 20 [{label}] 12 requests over {ENC_CLIPS} clips: run {run_s:.2f} s "
          f"({out[1]['decode_ticks']} decode ticks, {out[1]['prefill_launches']} prefills, "
          f"{out[2]['encoder_launches']} encodes, {st['prefix_hits'] - ENC_REQS} prefix hits "
          f"then all {ENC_REQS} warmed); steady tick (8 rows, {n_time} ticks): wall "
          f"{wall:.2f} ms/tick, {_profile_txt(prof, wall)}; {_host_txt(host)}; prefill on a "
          f"hit {hit_tok_s:.0f} tok/s", flush=True)
    nodes = {k: eng._graphs.node_count(k) for k in eng._graphs.buckets} if graphs else {}
    return {"out": out, "bits": bits, "counts": counts, "wall": wall, "prof": prof,
            "host": host, "nodes": nodes, "engine": eng, "hit_tok_s": hit_tok_s}


def encdec_launch_checks(api, params, clips, prompts):
    """Every B1 launch of the first engine step (3 encodes, 8 exact-length
    prefills on the encoder pages, a decode tick), of a steady tick and of
    a checkpoint tick held to plain on its own inputs (eager depth 1).
    Returns (launches held, worst max|err|, the shapes)."""
    cfg = api.cfg
    enc, dec = _encdec_per_encode(cfg), ENC_PER_DEC_LAYER * cfg.n_layers
    eng = encdec_engine(api, params, False, 1)
    encdec_submit(eng, clips, prompts)
    _, first, e1 = hold_b1(eng.step, "phase 20 first step")
    _, steady, e2 = hold_b1(eng.step, "phase 20 steady tick")
    while not any((s.pos + 1) % STATE_PS == 0 for s in eng.slots if s.req is not None):
        eng.step()
    _, ckpt, e3 = hold_b1(eng.step, "phase 20 checkpoint tick")
    eng.run_to_completion()
    eng.audit(strict=True)
    want_first = ENC_CLIPS * enc + (ENC_SLOTS + 1) * dec
    for name, got, want in (("first step", first, want_first), ("steady tick", steady, dec),
                            ("checkpoint tick", ckpt, dec)):
        if sum(got.values()) != want:
            fail(f"phase 20: {sum(got.values())} B1 launches held in the {name}, expected {want}")
    d, f, t = cfg.d_model, cfg.d_ff, cfg.encoder_len
    need = {"first step": (first, [(t, d, d), (t, d, f), (t, f, d), (max(ENC_PROMPT_LENS), d, d)]),
            "steady tick": (steady, [(ENC_SLOTS, d, d), (ENC_SLOTS, d, f), (ENC_SLOTS, f, d)])}
    for name, (got, keys) in need.items():
        if not all(k in got for k in keys):
            fail(f"phase 20: the {name}'s held shapes {sorted(got)} miss {keys}")
    n = sum(sum(x.values()) for x in (first, steady, ckpt))
    shapes = sorted(set(first) | set(steady))
    worst = max(e1, e2, e3)
    print(f"phase 20 every B1 launch held to plain on its own inputs: the first step (3 encodes "
          f"× {enc} at M {t} + 8 prefills of 4–224 tokens and a decode tick × {dec} = "
          f"{sum(first.values())}), a steady tick ({sum(steady.values())}) and a checkpoint "
          f"tick ({sum(ckpt.values())}): {n} launches at (M, K, N) {shapes}; max|err| "
          f"{worst:.3e} (rtol={LINEAR_TOL}, atol={LINEAR_TOL}·max|plain|)", flush=True)
    return n, worst, shapes


def encdec_preempted(api, params, clips, prompts, host_pages=0):
    """The 12 requests (graph depth 2) with request 7 (the youngest)
    preempted after ``STATE_PREEMPT_AT`` ticks and resumed, encoding nothing
    again.  Returns (engine, outcome, the resumed request's admission ms)."""
    import torch

    eng = encdec_engine(api, params, True, 2, host_pages=host_pages)
    encdec_submit(eng, clips, prompts)
    for _ in range(STATE_PREEMPT_AT):
        eng.step()
    if eng._preempt_one(None) is None or eng.queue[0].rid != ENC_SLOTS - 1:
        fail("phase 20: the preemption did not take request 7")
    if eng.queue[0]._enc_page is None:
        fail("phase 20: the preempted request does not carry its encoder page")
    log = _timed_admits(eng)
    eng.run_to_completion()
    torch.cuda.synchronize()
    admits = [ms for rid, ms in log if rid == ENC_SLOTS - 1]
    if len(admits) != 1:
        fail(f"phase 20: request 7 readmitted {len(admits)} times")
    out = _state_outcome(eng)
    if out[2]["encoder_launches"] != ENC_CLIPS:
        fail(f"phase 20: the resume encoded again ({out[2]['encoder_launches']} encodes)")
    eng.audit(strict=True)
    return eng, out, admits[0]


def encdec_replay_held(api, params, clips, prompts, timed):
    """The checkpoint resume of ``encdec_preempted`` again, every replay
    launch (a decoder pass a replayed token, cross-attending to the carried
    encoder page) held (``replay_held``)."""
    eng = encdec_engine(api, params, True, 2)
    encdec_submit(eng, clips, prompts)
    for _ in range(STATE_PREEMPT_AT):
        eng.step()
    eng._preempt_one(None)
    return replay_held(eng, ENC_PER_DEC_LAYER * api.cfg.n_layers, timed, "phase 20")


def _b1_trace(run, plain):
    """``run()`` with every B1 launch recorded (its activation, its s_X),
    through the kernel or, with ``plain``, through its plain version
    (``fused_linear_ref``).  Returns (what ``run`` returned, the launches)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fused_linear_ref

    real, log = ops.bcq_linear, []

    def linear(x, w_idx, w_sel, w_inv, cb, s_x, cfg):
        log.append((x.clone(), s_x))
        if plain:
            return fused_linear_ref(x, w_idx, w_sel, w_inv, cb, cfg, s_x, valid_k=x.shape[1])
        return real(x, w_idx, w_sel, w_inv, cb, s_x, cfg)

    ops.bcq_linear = linear
    try:
        return run(), log
    finally:
        ops.bcq_linear = real


def held_to_first_flip(tag, run):
    """Kernels vs plain on identical inputs through ``run``, held launch by
    launch: each B1 launch's activation must be the plain run's within
    ``LINEAR_TOL`` · max|x| (B1's f32 sum order, nothing more) until the
    first launch whose activation encodes to other codes in the two runs
    (a W4A4 flip: the noise crossed an encode boundary; every later launch
    sees other inputs); with no flip the output is held within
    ``STATE_LOGIT_RTOL`` · max|plain|, with one it is printed and the flip
    named.  Returns the launch index of the flip, or None."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.core.calibrate import default_universal_codebooks

    out_k, log_k = _b1_trace(run, plain=False)
    out_p, log_p = _b1_trace(run, plain=True)
    if len(log_k) != len(log_p):
        fail(f"{tag}: {len(log_k)} B1 launches through the kernels, {len(log_p)} plain")
    cfg, flip = bcq.BCQConfig(), None
    cb = default_universal_codebooks().as_tensor("cuda")
    for i, ((xk, sk), (xp, sp)) in enumerate(zip(log_k, log_p)):
        gap = float((xk - xp).abs().max())
        if gap > LINEAR_TOL * float(xp.abs().max()):
            fail(f"{tag}: B1 launch {i}'s activation parts from the plain run's by {gap:.3e} "
                 "before any W4A4 flip")
        ek, ep = bcq.encode(xk, cb, cfg, s_x=sk), bcq.encode(xp, cb, cfg, s_x=sp)
        if not all(torch.equal(getattr(ek, f), getattr(ep, f))
                   for f in ("scale_code", "packed_sel", "packed_idx")):
            flip = i
            break
    kp = _compare(f"{tag} kernels vs plain", out_k.float(), out_p.float())
    if flip is None:
        if kp["max"] > STATE_LOGIT_RTOL * kp["scale"]:
            fail(f"{tag}: no W4A4 flip, yet the kernel path differs from the plain path by "
                 f"{kp['max']:.3e}, beyond {STATE_LOGIT_RTOL} · {kp['scale']:.3f}")
        print(f"{tag}: all {len(log_k)} B1 launches encode alike; kernels vs plain max|Δ| "
              f"{kp['max']:.3e} within {STATE_LOGIT_RTOL} · max|plain|", flush=True)
    else:
        print(f"{tag}: held launch by launch up to B1 launch {flip} of {len(log_k)}, where a "
              f"W4A4 flip parts the runs (its activations within {LINEAR_TOL} · max|x|, their "
              f"encodes apart); the output after it printed above, not held", flush=True)
    return flip


def encdec_blocks(cfg, clips, prompts):
    """Kernels vs plain at the full width on identical inputs
    (``held_to_first_flip``): one encoder block's output (a 1-layer
    encoder over clips 0 and 1) and one decoder block's logits (a 1-layer
    decoder over 8 prompts cut to 36 tokens, cross-attending to the plain
    path's encoder output).  The 6 + 6-layer model's prefill logits are
    printed, not held: W4A4 flips from B1's f32 sum order cascade there.
    Returns the flips (launch index or None) of the two blocks."""
    import dataclasses

    import torch

    from repro_torch.launch.serve import build_model
    from repro_torch.models import encdec, transformer

    frames = torch.from_numpy(np.stack(clips[:2])).cuda()
    rows = [p for p in prompts if len(p) >= ENC_PROMPT_LENS[1]][:ENC_SLOTS]
    s = min(len(p) for p in rows)
    tokens = torch.from_numpy(np.stack([p[:s] for p in rows]).astype(np.int32)).cuda()
    pos = torch.arange(s, device=tokens.device)[None].expand(tokens.shape)

    one = dataclasses.replace(cfg, n_encoder_layers=1, n_layers=1)
    api, params = build_model(one, "bcq4", True, "cuda", 0, True)
    f_enc = held_to_first_flip("phase 20 one encoder block (output)",
                               lambda: encdec.encode(params, frames, one, api.rt))
    enc_out, _ = _b1_trace(lambda: encdec.encode(params, frames, one, api.rt), plain=True)
    enc_out = enc_out.repeat_interleave(ENC_SLOTS // 2, 0)

    def dec():
        x, _ = encdec.decoder(params, tokens, enc_out, one, api.rt, pos)
        return transformer.lm_logits(params, x, api.rt)

    f_dec = held_to_first_flip("phase 20 one decoder block (logits)", dec)
    del api, params
    api, params = build_model(cfg, "bcq4", True, "cuda", 0, True)
    batch = {"tokens": tokens, "frames": frames.repeat_interleave(ENC_SLOTS // 2, 0)}

    def full():
        return api.prefill_fn(params, batch, ENC_MAX_LEN)[0]

    _compare("phase 20 the 6 + 6-layer prefill logits kernels vs plain (printed, not held)",
             _b1_trace(full, plain=False)[0].float(), _b1_trace(full, plain=True)[0].float())
    torch.cuda.empty_cache()
    return f_enc, f_dec


def encdec_eval(api, params, clips):
    """The evaluation forward (``loss_fn``) on 4 clips × 448 tokens in bf16
    with ``flash_kernel``: the decoder's causal self-attention through B5
    at (32, 448, 64), every B1 and B5 launch counted exactly and held to
    plain on its own inputs (``check_eval_launches``).  Returns (launches
    by kernel, worst max|err| by kernel, wall ms)."""
    import dataclasses

    import torch

    from repro_torch.kernels import build
    from repro_torch.models import zoo

    cfg = api.cfg
    rt = dataclasses.replace(api.rt, compute_dtype=torch.bfloat16, flash_kernel=True)
    api_e = zoo.build(cfg, rt, device="cuda")
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (ENC_EVAL_CLIPS, ENC_MAX_LEN + 1))
                              .astype(np.int32)).cuda()
    frames = torch.from_numpy(np.stack([clips[i % len(clips)]
                                        for i in range(ENC_EVAL_CLIPS)])).cuda()
    batch = {"frames": frames, "tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    expect = {"flash_attention": cfg.n_layers,
              "bcq_linear": _encdec_per_encode(cfg) + ENC_PER_DEC_LAYER * cfg.n_layers}
    torch.cuda.synchronize()
    build.reset_counts()
    loss = float(api_e.loss_fn(params, batch))
    counts = {k: build.counts().get(k, 0) for k in expect}
    if counts != expect:
        fail(f"phase 20: the evaluation forward launched {counts}, expected {expect}")
    api_p = zoo.build(cfg, dataclasses.replace(rt, fused_linear=False, flash_kernel=False),
                      device="cuda")
    loss_p = float(api_p.loss_fn(params, batch))
    if not (np.isfinite(loss) and abs(loss - loss_p) <= 0.05 * abs(loss_p)):
        fail(f"phase 20: the evaluation loss {loss} (kernels) vs {loss_p} (plain)")
    worst = check_eval_launches(api_e, params, batch, expect)
    wall = cuda_ms(lambda: api_e.loss_fn(params, batch), iters=3, warmup=1)
    print(f"phase 20 evaluation forward (loss_fn, {ENC_EVAL_CLIPS} clips × {ENC_MAX_LEN} "
          f"tokens, bf16, flash_kernel): loss {loss:.5f} kernels, {loss_p:.5f} plain; launches "
          f"{counts} (B5 at ({ENC_EVAL_CLIPS * cfg.n_heads}, {ENC_MAX_LEN}, {cfg.head_dim})); "
          f"{wall:.2f} ms a forward", flush=True)
    return counts, worst, wall


def phase_encdec(cb, smi):
    """Phase 20: full-width Whisper-base (``whisper_base``: 6 encoder and 6
    decoder layers, d 512, 8 heads of 64, d_ff 2048, gelu, layernorm, vocab
    51865 padded to 51968, tied; 1,500 stub frames; seeded weights packed
    to W4, f32 compute, a bcq4 decoder self cache, max_len 448) served in
    W4A4 through StatePagedEngine with its encoder output in shared_ro
    pages: 12 requests over 3 clips (decoder prompts of 4–224 tokens, 48
    tokens each; 8 slots, page 16) — 3 encodes and 9 prefix hits, graph
    depth 2 ≡ eager depth 1 bit for bit (encoder pool bytes too), exact B1
    counts (48 an encode, 48 a decoder pass), a steady tick one graph
    replay and no eager kernel; every B1 launch of the first step, a
    steady and a checkpoint tick held to plain; request 7 preempted after
    20 ticks and resumed from its checkpoint (every replay launch held,
    nothing encoded again) and from the host tier (bit-exact); a best-of-2
    fork sharing the encoder page; the reference CI's hot chaos run; one
    encoder block and one decoder block kernels vs plain, held launch by
    launch up to the first W4A4 flip; the evaluation forward in bf16
    through B5 at (32, 448, 64).  Returns (B1 launches, B5 launches, the
    ``kernels`` entries' fields for B1 and B5, worst errors)."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.serve import build_model
    from repro_torch.serving.generate import Request
    from repro_torch.serving.pages import REPLICATED, tree_leaves

    t_phase = time.perf_counter()
    cfg = get_arch(ENC_ARCH)
    clips, prompts = encdec_inputs(cfg)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    api, params = build_model(cfg, "bcq4", True, "cuda", 0, True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = (torch.cuda.memory_allocated() - before) / 1e9
    probe = encdec_engine(api, params, False, 1)
    page_b = sum(t[0].numel() * t.element_size() for t, ax in
                 zip(tree_leaves(probe.spool), tree_leaves(probe.axes)) if ax != REPLICATED)
    enc_b = sum(t.numel() * t.element_size() for t in probe.enc_pool)
    n_pages = probe.pool_mgr.n_pages
    print(f"phase 20 {cfg.name}: {cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, "
          f"d {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"{cfg.encoder_len} frames, vocab {cfg.vocab} (padded {cfg.vocab_padded}): drawn and "
          f"packed in {init_s:.1f} s, {resident:.3f} GB resident; an engine of {n_pages} pages: "
          f"a state page (the decoder's bcq4 self cache, {ENC_MAX_LEN} tokens) {page_b} B, the "
          f"encoder pool {enc_b / 1e9:.3f} GB ({n_pages} pages × {enc_b // n_pages} B)",
          flush=True)
    del probe
    launches = 0

    # the production tick: graph depth 2 ≡ eager depth 1
    ways = [(_way_name(g, d), encdec_way(api, params, clips, prompts, g, d))
            for g, d in ((True, 2), (False, 1))]
    (n_g, g2), (n_e, e1) = ways
    for part in ("out", "counts"):
        if g2[part] != e1[part]:
            fail(f"phase 20: {n_g} and {n_e} differ in their {part}")
    if not all(torch.equal(a, b) for a, b in zip(g2["bits"], e1["bits"])):
        fail(f"phase 20: {n_g} and {n_e} leave different live-tree, state or encoder pool bytes")
    launches += 2 * g2["counts"]["bcq_linear"]
    eng = g2["engine"]
    by = _device_kernels(lambda: eng._graphs.run(False), 3)
    b1 = None if by is None else sum(ms for nm, ms in by[2].items()
                                     if "encode_kernel" in nm or "gemm_" in nm)
    fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"  # noqa: E731
    dec = ENC_PER_DEC_LAYER * cfg.n_layers
    print(f"phase 20: graph depth 2 ≡ eager depth 1 bit for bit (tokens, margins, launch "
          f"indices, counters, live tree, state and encoder pool bytes, "
          f"{g2['counts']['bcq_linear']} B1 launches: {_encdec_per_encode(cfg)} an encode, {dec} "
          f"a decoder pass); decode graph nodes {g2['nodes']}; steady tick wall "
          f"{g2['wall']:.2f} ms graph depth 2, {e1['wall']:.2f} ms eager depth 1; one graph "
          f"replay's device time {fmt(None if by is None else by[1])}, of it B1 ({dec} launches) "
          f"{fmt(b1)}; {smi}", flush=True)
    hit_tok_s = g2["hit_tok_s"]
    for _, w in ways:
        w.pop("engine")
    del eng, ways

    n_held, worst, _ = encdec_launch_checks(api, params, clips, prompts)

    # one encode (M 1500 through the 6 encoder layers and the cross K/V), timed
    pool = api.enc_pool_init(2)
    frames = torch.from_numpy(clips[0])[None].cuda()
    enc_ms = cuda_ms(lambda: api.enc_store_fn(pool, api.encode_xkv_fn(params, frames), 1),
                     iters=10)
    del pool

    # preemption: request 7 resumed from its checkpoint and from the host tier
    base = encdec_engine(api, params, True, 2)
    encdec_submit(base, clips, prompts)
    base.run_to_completion()
    base_out = _state_outcome(base)[0]
    del base
    build.reset_counts()
    ck, ck_out, ck_ms = encdec_preempted(api, params, clips, prompts)
    _encdec_counts_ok(ck, build.counts(), "checkpoint resume")
    launches += build.counts().get("bcq_linear", 0)
    build.reset_counts()
    ho, ho_out, ho_ms = encdec_preempted(api, params, clips, prompts, host_pages=STATE_HOST_PAGES)
    launches += build.counts().get("bcq_linear", 0)
    build.reset_counts()
    n_rep, err_rep = encdec_replay_held(api, params, clips, prompts, ck_out)
    launches += build.counts().get("bcq_linear", 0)
    worst = max(worst, err_rep)
    cs, sw = ck_out[2], ho_out[3]
    if not (0 < cs["replay_tokens"] <= STATE_PS and cs["state_restores"] == 1):
        fail(f"phase 20: checkpoint resume replayed {cs['replay_tokens']} tokens "
             f"({cs['state_restores']} restores), expected 1..{STATE_PS}")
    if ho_out[2]["replay_tokens"] or sw["verified_swapins"] != 1 or sw["swap_outs"] != 1:
        fail(f"phase 20: host resume {ho_out[2]}, swap {sw}")
    if ho_out[0] != base_out:
        fail("phase 20: the host-tier resume is not bit-exact to the never-preempted run")
    flips = sum(x != y for k in base_out for x, y in zip(base_out[k][0], ck_out[0][k][0]))
    swap = time_state_swap(ck, "phase 20")
    del ck, ho
    print(f"phase 20 request 7 preempted after {STATE_PREEMPT_AT} ticks, no encode again: "
          f"checkpoint resume replayed {cs['replay_tokens']} tokens in {ck_ms:.2f} ms (its "
          f"{n_rep} B1 launches, M 1, held to plain: max|err| {err_rep:.3e}; tokens vs the "
          f"never-preempted run: {flips} of {sum(len(v[0]) for v in base_out.values())} "
          f"differ, as W4A4 allows); host-tier resume 0 replayed in {ho_ms:.2f} ms, bit-exact; "
          f"one state page ({swap['bytes']} B) through the host tier: fetch "
          f"{swap['fetch']:.3f} ms, put {swap['put']:.3f} ms, take {swap['take']:.3f} ms, "
          f"insert {swap['insert']:.3f} ms; audits clean", flush=True)

    # a best-of-2 fork shares the encoder page
    build.reset_counts()
    e = encdec_engine(api, params, True, 2)
    e.submit(Request(rid=0, prompt=prompts[1], max_new=ENC_GEN - 1, n_samples=2,
                     frames=clips[0]))
    e.step()
    sib = [s for s in e.slots if s.req is not None]
    if len(sib) != 2 or sib[0].enc_page != sib[1].enc_page or \
            e.pool_mgr.refcount[sib[0].enc_page] != 2:
        fail("phase 20: the fork's siblings do not share one encoder page")
    fin, _ = e.run_to_completion()
    e.audit(strict=True)
    if fin[0].out != fin[1].out or e.health()["state_counters"]["encoder_launches"] != 1 \
            or e.stats["shared_pages"] != 2:
        fail(f"phase 20: a greedy best-of-2 gave {[r.out[:4] for r in fin]}, "
             f"{e.health()['state_counters']}, shared pages {e.stats['shared_pages']}")
    del e
    launches += build.counts().get("bcq_linear", 0)
    print("phase 20 best-of-2 (graph depth 2): the siblings share the encoder page (refcount "
          "2, one encode) and the checkpoint page, greedy siblings identical", flush=True)

    # the reference CI's hot state-layout chaos run, at graph depth 2
    path = os.path.join(ROOT, "build", "chaos_encdec.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    build.reset_counts()
    rep = serve.run_chaos(api, params, prompts[:4], HYB_CHAOS_GEN, page_size=STATE_PS,
                          report_path=path, arch=cfg.name, frames=clips[0], **HYB_CHAOS)
    launches += build.counts().get("bcq_linear", 0)
    check = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "check_chaos.py"), path],
                           capture_output=True, text=True, timeout=120)
    print(f"phase 20 hot chaos run (seed {HYB_CHAOS['seed']}, rate {HYB_CHAOS['rate']}, audit "
          f"every tick) tools/check_chaos.py (exit {check.returncode}): "
          f"{(check.stdout + check.stderr).strip()}; faults {rep['faults']['by_site']}",
          flush=True)
    if (check.returncode or rep["page_layout"] != "state" or not rep["final_audit"]["ok"]
            or rep["unhandled_exception"] is not None or rep["leaked_pages"]):
        fail("phase 20: the hot chaos run is not contained")

    counts_ev, err_ev, eval_ms = encdec_eval(api, params, clips)
    launches += counts_ev["bcq_linear"]
    worst = max(worst, err_ev["bcq_linear"])
    del api, params
    torch.cuda.empty_cache()
    flips = encdec_blocks(cfg, clips, prompts)

    lin = {"at_encdec_encode": dict(_linear_times(cb, cfg.encoder_len, cfg.d_model, cfg.d_ff, 91),
                                    shape=f"M {cfg.encoder_len} K {cfg.d_model} N {cfg.d_ff} "
                                          "(whisper_base encoder mlp-in)"),
           "at_encdec_decode": dict(_linear_times(cb, ENC_SLOTS, cfg.d_ff, cfg.d_model, 90),
                                    shape=f"M {ENC_SLOTS} K {cfg.d_ff} N {cfg.d_model} "
                                          "(whisper_base decode mlp-out)")}
    bh = ENC_EVAL_CLIPS * cfg.n_heads
    ft = _flash_times(bh, ENC_MAX_LEN, cfg.head_dim, cfg.n_heads)
    ft.pop("inputs")
    print(f"flash timing at BH={bh} S={ENC_MAX_LEN} D={cfg.head_dim} bf16 causal (whisper_base "
          f"evaluation): kernel {ft['ms']:.4f} ms, plain {ft['plain_ms']:.4f} ms, SDPA "
          f"{ft['library_ms']:.4f} ms, bound {ft['bound_ms']:.5f} ms by {ft['bound_by']}; kernel "
          f"vs plain max|err| {ft['err']:.3e}", flush=True)
    flash = {"at_encdec_eval": {k: ft[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by")}
             | {"shape": f"BH {bh} S {ENC_MAX_LEN} D {cfg.head_dim} bf16 causal"}}
    print(f"phase 20 summary ({smi}): steady graph tick {g2['wall']:.2f} ms wall, "
          f"{_profile_txt(g2['prof'], g2['wall'])}; graph nodes {g2['nodes']}; an encode "
          f"{enc_ms:.3f} ms; prefill on a hit {hit_tok_s:.0f} tok/s; resume {ck_ms:.2f} ms "
          f"(checkpoint) / {ho_ms:.2f} ms (host tier); evaluation forward {eval_ms:.2f} ms; "
          f"{n_held} B1 launches held; W4A4 flips at B1 launch {flips} (encoder block, decoder "
          f"block; None: none); phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, counts_ev["flash_attention"], lin, flash, {
        "bcq_linear": worst, "flash_attention": max(err_ev["flash_attention"], ft["err"])}


# ------------------------------------------------------------------ phase 22
ZOO_ARCHS = ("qwen2_0_5b", "starcoder2_3b", "phi3_medium_14b", "qwen1_5_32b")
# the depth cuts that keep the script in its time (widths whole): of 24,
# 30, 40 and 64 layers, a quarter or so, to make room for phase 26 (the
# batcher's eager decode costs ~8 ms a layer)
ZOO_LAYERS = {"qwen2_0_5b": 6, "starcoder2_3b": 8, "phi3_medium_14b": 10, "qwen1_5_32b": 8}
ZOO_COUNTED = ("bcq_linear", "page_gather", "bcq_page_write")
ZOO_TIME_TICKS = 6  # steady ticks timed on the host clock
# tokens a request in the ContinuousBatcher comparison: its contiguous
# decode is eager (~8 ms a layer on the card) and launches once per
# position group, 8 a tick on phase 4's prompts; the W4A4 runs part within
# the first tokens, so a longer run adds time and no comparison
ZOO_BATCHER_GEN = 4
VLM_ARCH = "pixtral_12b"
VLM_PROMPTS, VLM_PROMPT_LEN, VLM_GEN = 4, 320, 16
# (C, K, N) of the zoo's new fused-linear shapes: Qwen2's K/V projection
# (K 896 = 14 arrays, N 128), StarCoder2's (3072 → 256), Qwen1.5-32B's MLP
# in at a 512-row prefill chunk (8 rows × 64)
ZOO_LINEAR = [(8, 896, 128), (8, 3072, 256), (512, 5120, 27392)]
# (H, Hkv, D) of the zoo's page pools: query groups of 7, 12, 4 and 1
ZOO_GQA = {"qwen2_0_5b": (14, 2, 64), "starcoder2_3b": (24, 2, 128),
           "phi3_medium_14b": (40, 10, 128), "qwen1_5_32b": (40, 40, 128)}


def _zoo_per_layer(cfg) -> dict:
    """Launches a layer and forward pass: B1 for q, k, v, o and the MLP (two
    inputs under SwiGLU, one under GELU) and one out; one B2 and one writer."""
    return {"bcq_linear": 4 + (3 if cfg.act == "swiglu" else 2), "page_gather": 1,
            "bcq_page_write": 1}


def _zoo_counts_ok(counts, passes, cfg, what, label="phase 22"):
    per = _zoo_per_layer(cfg)
    expect = {n: v * cfg.n_layers * passes for n, v in per.items()}
    if any(counts.get(n, 0) != v for n, v in expect.items()) or not passes:
        fail(f"{label} {cfg.name} {what}: launches {counts}, expected {expect} "
             f"({cfg.n_layers} layers × {per} a layer × {passes} passes)")
    return expect


@contextlib.contextmanager
def held_layer(cfg, layer, label, cb, bcq_cfg=None):
    """Within the block, every B1, B2 and KV-page writer launch of layer
    ``layer`` is held to its plain version on its own inputs (B1
    ``fused_linear_ref``, B2 ``page_gather_attention_plain``, the writer the
    plain writer on a copy of its pool, bytes equal but for codebook ties);
    the other layers' launches run unheld.  A forward pass runs the layers
    in order with a fixed count of each kernel a layer, so a kernel's i-th
    call belongs to layer (i // per) % L.  Yields (launches by kernel,
    launches held by kernel, worst max|err| by kernel), filled as it runs."""
    from repro_torch.kernels import chunked_prefill, common, ops, paged_attention
    from repro_torch.kernels.ref import fused_linear_ref
    from repro_torch.models import layers

    per = _zoo_per_layer(cfg)
    calls = {k: 0 for k in ZOO_COUNTED}
    n = {k: 0 for k in ZOO_COUNTED}
    worst = {k: 0.0 for k in ZOO_COUNTED}

    def mine(name):
        i = calls[name]
        calls[name] += 1
        return (i // per[name]) % cfg.n_layers == layer

    def tally(name, ok, err, what):
        if not ok:
            fail(f"{label}: a {name} launch of layer {layer} disagrees with its plain version on "
                 f"its own inputs ({what}): {err}")
        n[name] += 1
        worst[name] = max(worst[name], err)

    real = {"dense": ops.bcq_linear, "decode": paged_attention.page_gather_attention,
            "chunk": chunked_prefill.page_gather_attention,
            "paged_token_write": layers.paged_token_write,
            "paged_chunk_write": layers.paged_chunk_write}

    def dense(x, w_idx, w_sel, w_inv, cbk, s_x, bcfg):
        out = real["dense"](x, w_idx, w_sel, w_inv, cbk, s_x, bcfg)
        if mine("bcq_linear"):
            ref = fused_linear_ref(x, w_idx, w_sel, w_inv, cbk, bcfg, s_x, valid_k=x.shape[1])
            tally("bcq_linear", *held(out, ref, LINEAR_TOL, LINEAR_TOL * float(ref.abs().max())),
                  f"M={x.shape[0]} K={x.shape[1]} N={w_idx.shape[0]}")
        return out

    def gather(key):
        def run(q, pool, bt, kv_len, kind, bcfg, cbk=None):
            out = real[key](q, pool, bt, kv_len, kind, bcfg, cbk)
            if mine("page_gather"):
                ref = common.page_gather_attention_plain(q, pool, bt, kv_len, kind, bcfg, cbk)
                tally("page_gather", *held(out, ref, GATHER_TOL, GATHER_TOL),
                      f"{kind} q {tuple(q.shape)} maxp {bt.shape[1]}")
            return out
        return run

    def write(name):
        def run(pool, *args, **kw):
            if not mine("bcq_page_write"):
                return real[name](pool, *args, **kw)
            before = {k: t.clone() for k, t in pool.items()}
            out = real[name](pool, *args, **kw)
            plain = {k: t.clone() for k, t in before.items()}
            real[name](plain, *args, **dict(kw, kernel=False))
            diff = _pool_diff(out, plain, cb, bcq_cfg)
            tally("bcq_page_write", diff >= 0, max(diff, 0), f"{name} k {tuple(args[0].shape)}")
            return out
        return run

    ops.bcq_linear = dense
    paged_attention.page_gather_attention = gather("decode")
    chunked_prefill.page_gather_attention = gather("chunk")
    layers.paged_token_write = write("paged_token_write")
    layers.paged_chunk_write = write("paged_chunk_write")
    try:
        yield calls, n, worst
    finally:
        ops.bcq_linear = real["dense"]
        paged_attention.page_gather_attention = real["decode"]
        chunked_prefill.page_gather_attention = real["chunk"]
        layers.paged_token_write = real["paged_token_write"]
        layers.paged_chunk_write = real["paged_chunk_write"]


def hold_layer(eng, layer, label):
    """One step of ``eng`` (eager) under ``held_layer``, every kernel's
    launches counted against its per-layer count and the step's forward
    passes.  Returns (launches held by kernel, worst max|err| by kernel,
    the step's passes)."""
    cfg = eng.api.cfg
    per = _zoo_per_layer(cfg)
    before = eng.stats["decode_ticks"] + eng.stats["prefill_launches"]
    with held_layer(cfg, layer, label, eng.params["codebooks"], eng.api.rt.bcq_cfg) as (
            calls, n, worst):
        eng.step()
    passes = eng.stats["decode_ticks"] + eng.stats["prefill_launches"] - before
    for name in ZOO_COUNTED:
        if n[name] != per[name] * passes or calls[name] != per[name] * cfg.n_layers * passes:
            fail(f"{label}: {name} held {n[name]} of {calls[name]} launches over {passes} "
                 f"passes; expected {per[name]} of {per[name] * cfg.n_layers} a pass")
    return n, worst, passes


def zoo_launch_checks(model, prompts, label):
    """Every launch of the last layer in the first engine step (a prefill
    chunk of every prompt, then a decode tick) and in a steady decode tick
    (8 rows decoding) held to its plain version (``hold_layer``), eager
    at depth 1.  Returns (worst max|err| by kernel, launches held)."""
    eng = _fresh_engine(model, prompts)
    layer = model.api.cfg.n_layers - 1
    first, worst1, passes = hold_layer(eng, layer, label)
    while eng.queue or any(s.mode == "prefill" for s in eng.slots if s.req is not None):
        eng.step()
    eng.step()
    if sum(s.req is not None and s.mode == "decode" for s in eng.slots) != len(prompts):
        fail(f"{label}: the steady tick of the launch checks has not {len(prompts)} rows decoding")
    steady, worst2, _ = hold_layer(eng, layer, label)
    worst = {k: max(worst1[k], worst2[k]) for k in worst1}
    print(f"{label} every B1, B2 and writer launch of layer {layer} in the first engine step "
          f"({passes} passes: a prefill chunk of every prompt, a decode tick) and in a steady "
          f"decode tick ({len(prompts)} rows) vs its plain version on its own inputs: launches "
          f"{first} + {steady}; max|err| B1 {worst['bcq_linear']:.3e} (rtol={LINEAR_TOL}, "
          f"atol={LINEAR_TOL}·max|plain|), B2 {worst['page_gather']:.3e} (atol=rtol="
          f"{GATHER_TOL}); page bytes equal to the plain writer's ({worst['bcq_page_write']} "
          f"differing idx/sel bytes, codebook ties)", flush=True)
    del eng
    return worst, {k: first[k] + steady[k] for k in first}


def zoo_batcher(model, prompts, ref, label):
    """Phase 4's prompts again through ``ContinuousBatcher`` over the same
    model (one slot a request, a per-request prefill over a contiguous
    cache of the engine's max_len, one decode launch per position group),
    ``ZOO_BATCHER_GEN`` tokens a request;
    prints its agreement with ``PagedEngine``'s chunked run (``ref``: rid →
    tokens).  Its launches
    are not counted (the B1 launches of a contiguous decode over every
    slot; no B2 or writer)."""
    import torch

    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.serving.generate import Request

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bat = ContinuousBatcher(model.api, model.params, n_slots=len(prompts), max_len=model.max_len)
    for i, p in enumerate(prompts):
        bat.submit(Request(rid=i, prompt=p, max_new=ZOO_BATCHER_GEN - 1))
    got, ticks = bat.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {r.rid: r for r in got}
    if sorted(got) != list(range(len(prompts))) or any(len(r.out) != ZOO_BATCHER_GEN
                                                       for r in got.values()):
        fail(f"{label}: ContinuousBatcher did not serve every request its {ZOO_BATCHER_GEN} tokens")
    same = sum(a == b for i in ref for a, b in zip(ref[i], got[i].out))
    whole = sum(ref[i][:ZOO_BATCHER_GEN] == got[i].out for i in ref)
    first = [next((j for j, (a, b) in enumerate(zip(ref[i], got[i].out)) if a != b), None)
             for i in sorted(ref)]
    print(f"{label} ContinuousBatcher (contiguous bcq4 cache, per-request prefill, "
          f"{bat.launches} launches over {ticks} ticks, {wall:.2f} s, the first "
          f"{ZOO_BATCHER_GEN} tokens a request): {same} of {len(ref) * ZOO_BATCHER_GEN} tokens "
          f"equal to PagedEngine's chunked run, {whole} of {len(ref)} requests whole; first "
          f"differing position by request {first} (W4A4: the chunked prefill's activation "
          f"scale spans 8 rows, the batcher's one prompt)", flush=True)
    return same


def _free_model():
    """Release a freed model's blocks: the engine and its decode graphs
    hold each other (a cycle, which only the collector frees), then the
    caching allocator's blocks go back to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _zoo_build(cfg):
    """(api, params, init seconds, the model's resident GB): seeded W4
    weights with a bcq4 pool and f32 compute, as phase 4's, drawn and
    packed a layer at a time on the card; the GB are what
    ``torch.cuda.memory_allocated`` grew by."""
    import torch

    from repro_torch.launch.serve import build_model

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    api, params = build_model(cfg, "bcq4", True, "cuda", 0, True)
    torch.cuda.synchronize()
    return api, params, time.perf_counter() - t0, (torch.cuda.memory_allocated() - base) / 1e9


def zoo_model(arch, cb, smi):
    """One dense zoo model at full width, its depth cut to ``ZOO_LAYERS``
    for the script's time: built packed (W4, bcq4
    pool, f32 compute) a layer at a time on the card, phase 4's workload
    through PagedEngine at graph depth 2 (launch counts exact, the steady
    tick's wall, busy and graph nodes), the last layer's launches held to
    plain, and the prompts again through ContinuousBatcher.  Returns (the
    main path's launches, worst held errors, a summary)."""
    import dataclasses
    from types import SimpleNamespace

    import torch

    from repro_torch.configs.base import get_arch

    t_model = time.perf_counter()
    cfg = get_arch(arch)
    if arch in ZOO_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=ZOO_LAYERS[arch])
    label = f"phase 22 {cfg.name}"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    api, params, init_s, gb = _zoo_build(cfg)
    print(f"{label}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim} over {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff} ({cfg.act}), vocab "
          f"{cfg.vocab} (padded {cfg.vocab_padded}), qkv_bias {cfg.qkv_bias}, tied "
          f"{cfg.tie_embeddings}: drawn and packed a layer at a time on the card in {init_s:.1f} s; "
          f"{gb:.2f} GB resident (torch.cuda.memory_allocated, the model's); {smi}", flush=True)
    model = SimpleNamespace(api=api, params=params, max_len=MOE_MAX_LEN)
    way = production_way(model, prompts, True, 2, ZOO_TIME_TICKS, label=label)
    runs = {rid: toks for (rid, _), (toks, _, _) in way["out"][0].items()}  # the first run's
    if sorted(runs) != list(range(len(prompts))):
        fail(f"{label}: the engine did not finish every request")
    for rid, toks in runs.items():
        if len(toks) != GEN or not all(0 <= t < cfg.vocab_padded for t in toks):
            fail(f"{label}: request {rid} got {len(toks)} tokens, expected {GEN} in [0, vocab)")
    st = way["out"][1]
    passes = st["decode_ticks"] + st["prefill_launches"]
    expect = _zoo_counts_ok(way["counts"], passes, cfg, "graph depth 2")
    counts = {n: way["counts"].get(n, 0) for n in ZOO_COUNTED}
    prof = way["prof"]
    busy = "not measured" if prof is None else f"{prof[1]:.3f} ms"
    summary = {"init_s": init_s, "resident_gb": gb, "wall_ms": way["wall"],
               "busy_ms": None if prof is None else prof[1], "nodes": way["nodes"]}
    print(f"{label}: PagedEngine (8 slots, page 16, chunk 64, bcq4) at graph depth 2: launches "
          f"{expect} over {passes} passes ({st['prefill_launches']} prefill, {st['decode_ticks']} "
          f"decode); steady tick (8 rows): wall {way['wall']:.2f} ms, device busy {busy}, "
          f"{_host_txt(way['host'])}; decode graph nodes {way['nodes']}; {smi}", flush=True)
    eng = way.pop("engine")
    way.pop("pool")
    worst, _ = zoo_launch_checks(model, prompts, label)
    zoo_batcher(model, prompts, runs, label)
    del eng, way, runs, model, api, params
    _free_model()
    print(f"{label}: {time.perf_counter() - t_model:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated", flush=True)
    return counts, worst, summary


def vlm_serve(cb, smi):
    """Full-width Pixtral-12B (``pixtral_12b``) contiguously: packed W4,
    bcq4 cache, f32 compute; 4 seeded prompts of 320 tokens with 256
    seeded stub patch embeddings written over their first positions, one
    batched prefill and 15 decode steps (``greedy_generate``), every B1
    launch of the last layer held to plain in the same run.  The patch
    embeddings must move the prefill's logits.  Returns (B1 launches,
    worst held error, a summary)."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import build
    from repro_torch.serving.generate import greedy_generate

    t_model = time.perf_counter()
    cfg = get_arch(VLM_ARCH)
    label = f"phase 22 {cfg.name}"
    api, params, init_s, gb = _zoo_build(cfg)
    print(f"{label}: vlm, {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim} (attention width {cfg.n_heads * cfg.head_dim}) over {cfg.n_kv_heads} KV "
          f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_patches} stub patches: drawn and "
          f"packed a layer at a time on the card in {init_s:.1f} s; {gb:.2f} GB resident; {smi}",
          flush=True)
    prompts = np.random.default_rng(23).integers(0, cfg.vocab, (VLM_PROMPTS, VLM_PROMPT_LEN))
    g = torch.Generator(device="cuda").manual_seed(24)
    pe = torch.randn((VLM_PROMPTS, cfg.n_patches, cfg.d_model), generator=g,
                     device="cuda") * 0.02
    max_len = VLM_PROMPT_LEN + VLM_GEN
    per = _zoo_per_layer(cfg)["bcq_linear"]
    layer = cfg.n_layers - 1
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.perf_counter()
    with held_layer(cfg, layer, label, params["codebooks"]) as (_, n_held, worst):
        out = greedy_generate(api, params, prompts, VLM_GEN, max_len, device=api.device,
                              batch={"patch_embeds": pe})
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.counts()
    n_b1 = per * cfg.n_layers * VLM_GEN
    if counts.get("bcq_linear", 0) != n_b1 or any(counts.get(n) for n in ZOO_COUNTED[1:]):
        fail(f"{label}: launches {counts}, expected {n_b1} B1 ({per} a layer × {cfg.n_layers} "
             f"layers × {VLM_GEN} passes) and no B2 or writer")
    if n_held["bcq_linear"] != per * VLM_GEN:
        fail(f"{label}: {n_held['bcq_linear']} B1 launches of layer {layer} held, expected "
             f"{per * VLM_GEN}")
    if out.shape != (VLM_PROMPTS, VLM_GEN) or not bool(((out >= 0) & (out < cfg.vocab_padded)).all()):
        fail(f"{label}: tokens {tuple(out.shape)} out of range")
    toks = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    with_pe, _ = api.prefill_fn(params, {"tokens": toks, "patch_embeds": pe}, max_len)
    without, _ = api.prefill_fn(params, {"tokens": toks}, max_len)
    if not bool(with_pe.isfinite().all()) or torch.equal(with_pe, without):
        fail(f"{label}: the prefill logits are not finite or ignore the patch embeddings")
    moved = float((with_pe - without).abs().max())
    print(f"{label} contiguous: prefill of {VLM_PROMPTS} × {VLM_PROMPT_LEN} tokens with "
          f"{cfg.n_patches} patch embeddings + {VLM_GEN - 1} decode steps in {wall:.2f} s "
          f"(the held layer's plain runs included); B1 launched {counts['bcq_linear']} = {per} × "
          f"{cfg.n_layers} × {VLM_GEN} passes, every launch of layer {layer} "
          f"({n_held['bcq_linear']}) held to plain: max|err| {worst['bcq_linear']:.3e}; the patch embeddings move the prefill logits by up "
          f"to {moved:.3f}; tokens of request 0 {out[0].tolist()}", flush=True)
    del api, params, out, with_pe, without
    _free_model()
    summary = {"init_s": init_s, "resident_gb": gb, "wall_s": wall}
    print(f"{label}: {time.perf_counter() - t_model:.1f} s", flush=True)
    return counts["bcq_linear"], worst["bcq_linear"], summary


def time_zoo(cb, smi):
    """The zoo's new kernel shapes timed beside their plain versions and
    bounds: B1 at ``ZOO_LINEAR`` (with bf16 ``torch.matmul``), B2 at each
    GQA config's decode (8 rows at the end of the serving run) and chunk
    (8 rows × 64 queries at 500 tokens), the writer at each KV head count's
    decode and prefill chunk.  Returns ``kernels``-line entries by kernel."""
    lin = {}
    for m, k, n in ZOO_LINEAR:
        lin[f"at_zoo_M{m}_K{k}_N{n}"] = dict(_linear_times(cb, m, k, n, 70 + m),
                                             shape=f"M {m} K {k} N {n}")
    gat, wri = {}, {}
    kv_dec = [p + GEN for p in PROMPT_LENS]
    for arch, (h, hkv, d) in ZOO_GQA.items():
        for c, kv in ((1, kv_dec), (64, [500] * 8)):
            t = _gather_times(cb, c, kv, 40 + c + h, h=h, hkv=hkv, d=d)
            shape = f"B 8 C {c} H {h} Hkv {hkv} D {d} bcq4 ({arch})"
            print(f"page_gather timing at {shape}: kernel {t['ms']:.4f} ms (device "
                  f"{t['device_ms']:.4f} ms, {t['timer']}), plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.5f} ms by {t['bound_by']}; kernel vs plain max|err| "
                  f"{t['err']:.3e}; {smi}", flush=True)
            gat[f"at_zoo_{arch}_C{c}"] = {k: t[k] for k in ("ms", "device_ms", "plain_ms",
                                                           "bound_ms", "bound_by", "timer")}
            gat[f"at_zoo_{arch}_C{c}"]["shape"] = shape
    for hkv, d in sorted({(v[1], v[2]) for v in ZOO_GQA.values()}):
        for c in (1, 64):
            t = _write_times(cb, c, 80 + c + hkv, h=hkv, d=d)
            shape = f"B 8 C {c} Hkv {hkv} D {d} f32"
            print(f"KV-page writer timing at {shape}: kernel {t['ms']:.4f} ms (device "
                  f"{t['device_ms']:.4f} ms, {t['timer']}), plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.5f} ms by {t['bound_by']}; {smi}", flush=True)
            wri[f"kv_write_at_zoo_Hkv{hkv}_D{d}_C{c}"] = dict(
                {k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "timer")}, shape=shape)
    return lin, gat, wri


def phase_zoo(cb, smi):
    """Phase 22: the rest of the model zoo.  The four public dense configs
    at full width (depth ``ZOO_LAYERS``) through PagedEngine
    in W4A4, one after the other (each freed before the next), then
    Pixtral-12B contiguously,
    then the zoo's new kernel shapes timed.  Returns (launches by kernel
    on the dense path, B1's launches on the vlm path, ``kernels``-line
    entries, worst held errors)."""
    t_phase = time.perf_counter()
    total = {n: 0 for n in ZOO_COUNTED}
    worst = {n: 0.0 for n in ZOO_COUNTED}
    summaries = {}
    for arch in ZOO_ARCHS:
        counts, w, summaries[arch] = zoo_model(arch, cb, smi)
        for n in ZOO_COUNTED:
            total[n] += counts[n]
            worst[n] = max(worst[n], w[n])
    vlm_b1, vlm_err, summaries[VLM_ARCH] = vlm_serve(cb, smi)
    worst["bcq_linear"] = max(worst["bcq_linear"], vlm_err)
    entries = time_zoo(cb, smi)
    print(f"phase 22 summary ({smi}): " + "; ".join(
        f"{a}: init {s['init_s']:.1f} s, {s['resident_gb']:.2f} GB"
        + (f", tick {s['wall_ms']:.2f} ms wall / "
           + ("not measured" if s["busy_ms"] is None else f"{s['busy_ms']:.3f} ms busy")
           + f", nodes {s['nodes']}" if "wall_ms" in s else f", {s['wall_s']:.2f} s")
        for a, s in summaries.items())
        + f"; dense launches {total}, vlm B1 {vlm_b1}; phase {time.perf_counter() - t_phase:.1f} s",
        flush=True)
    return total, vlm_b1, entries, worst


# ------------------------------------------------------------------ phase 23
MESH_STEPS = 3  # mesh steps held bit for bit to the plain step (b)
MESH_FAKE_STEPS = 2  # --quant fake mesh steps (c)
CDP_STEPS = 5  # compressed data-parallel steps (d)
DECODE_ROWS, DECODE_PROMPT, DECODE_MAX_LEN = 4, 64, 128  # the sequence-sharded decode (e)
DECODE_TOL = 1e-5  # (e): rtol and atol, logits of the flash combine vs the gathered softmax
# (e): the new token's bf16 K/V in layers 1 and up, relative: one bf16 rounding step (2⁻⁷
# of the value's binade).  They come from hidden states within ~DECODE_TOL of each other,
# and a value that close to a rounding boundary lands on its neighbour.
DECODE_KV_RTOL = 2.0 ** -7
PHASE21_MODEL_TFLOPS = 34.3  # PERF.md §5: 6·N·tokens a step over phase 21's measured step time
DRYRUN_CELL = ("whisper_base", "decode_32k", "single")  # the reference's 512-device test's cell


def _to_meta(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree.to("meta") if isinstance(tree, torch.Tensor) else tree


def _same_layout(meta, real, what):
    import torch

    if isinstance(real, dict):
        for k in real:
            _same_layout(meta[k], real[k], what)
    elif isinstance(real, (tuple, list)):
        for m, r in zip(meta, real):
            _same_layout(m, r, what)
    elif isinstance(real, torch.Tensor):
        if meta.device.type != "meta" or meta.shape != real.shape or meta.dtype != real.dtype:
            fail(f"phase 23 (f): {what}'s meta branch gave {tuple(meta.shape)} {meta.dtype} on "
                 f"{meta.device}, the launch {tuple(real.shape)} {real.dtype}")


def meta_held(name, fn, args, kwargs, nbytes, work, what, keep=()):
    """(f): ``fn`` on the card, then on meta copies of its inputs (the
    argument positions in ``keep`` stay as they are: host data a count
    reads); the meta outputs' shapes and dtypes equal the launch's, no
    launch is counted, and the meta count equals ``nbytes`` and ``work``
    ({unit: operations}), the script's own bound arithmetic.  Returns the
    bound (ms) both give."""
    from repro_torch.kernels import build

    real = fn(*args, **kwargs)
    build.reset_meta_cost()
    before = build.counts()
    meta = fn(*[a if i in keep else _to_meta(a) for i, a in enumerate(args)],
              **{k: _to_meta(v) for k, v in kwargs.items()})
    if build.counts() != before:
        fail(f"phase 23 (f): {what}'s meta call counted a launch")
    _same_layout(meta, real, what)
    got = build.meta_cost().get(name, {})
    units = {"int8": INT8_OPS, "bf16": BF16_FLOPS, "f32": F32_FLOPS}
    want = dict({u: 0 for u in units}, **work)
    if got.get("calls") != 1 or got["bytes"] != nbytes or any(got[u] != want[u] for u in units):
        fail(f"phase 23 (f): {what}'s meta count {got} is not the bound's {nbytes} B and {work}")
    bound, by = _bound(got["bytes"], *((got[u], units[u]) for u in units if got[u]))
    print(f"  {what}: meta outputs {[tuple(t.shape) for t in _tensors(meta)]} as the launch's; "
          f"{nbytes} B, {work}: bound {bound:.5f} ms by {by}", flush=True)
    return bound


def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def meta_branches(cb):
    """(f): the meta branch of each kernel at phase 10's shapes against the
    real launch, its count against the script's bound arithmetic."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_linear as bl, bcq_matmul as bm, bcq_quantize as bq
    from repro_torch.kernels import common, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    cfg = bcq.BCQConfig()
    cbw = 8 * 16 * 4
    for m, k, n in ((8, 768, 3072), (EVAL_SEQ * EVAL_BATCH, 768, 3072)):
        x, w = linear_case(m, k, n, 23, cb)
        s_x = bcq.tensor_scale(x, cfg)
        meta_held("bcq_linear", bl.bcq_linear,
                  (x, w.idx_packed, w.sel_packed, w.inv_scale, cb, s_x, cfg), {},
                  m * k * 4 + n * k // 2 + n * k // 16 + n * k // 64 * 4 + cbw + 4 + m * n * 4,
                  {"int8": 2 * m * n * k, "f32": ENCODE_OPS * m * k}, f"B1 M {m} K {k} N {n}")
    e, c, k, n = STACKED_SHAPES[0]
    x, w = stacked_case(e, c, k, n, 231, cb)
    s_x = bcq.tensor_scale(x, cfg)
    meta_held("bcq_linear_experts", bl.bcq_linear_experts,
              (x, w.idx_packed, w.sel_packed, w.inv_scale, cb, s_x, cfg), {},
              e * c * k * 4 + e * (n * k // 2 + n * k // 16 + n * k // 64 * 4) + cbw + 4
              + e * c * n * 4,
              {"int8": 2 * e * c * n * k, "f32": ENCODE_OPS * e * c * k}, f"B1s E {e} C {c}")
    ps, b, h, d = 16, 8, 12, 64
    for c, kv_len in ((1, [n + GEN for n in PROMPT_LENS]), (64, [500] * 8)):
        maxp = -(-max(kv_len) // ps)
        n_pages = 1 + b * maxp
        pool = gather_pool("bcq4", n_pages, ps, h, d, 232, cb)
        bt, kvl = gather_case(b, maxp, ps, kv_len, 233, n_pages)
        q = torch.randn((b, c, h, d), device="cuda")
        pages = sum(max(1, -(-n // ps)) for n in kv_len)
        nbytes = (q.numel() * 4 * 2 + 2 * pages * ps * h * (d // 2 + d // 16 + d // 64)
                  + bt.numel() * 4 + b * 4 + cbw + 8)
        seen = sum(n - c + i + 1 for n in kv_len for i in range(c))
        meta_held("page_gather", common.page_gather_attention,
                  (q, pool, bt, kvl.cpu(), "bcq4", cfg, cb), {}, nbytes,
                  {"f32": 4 * h * d * seen}, f"B2 C {c}", keep=(3,))
    m, k = EVAL_SEQ * EVAL_BATCH, 768
    x = activation(m, k, 234)
    meta_held("bcq_quantize", bq.bcq_quantize, (x, cb, bcq.tensor_scale(x, cfg), cfg), {},
              m * k * 4 + m * k // 2 + m * k // 16 + m * k // 64 * 4 + cbw + 4,
              {"f32": ENCODE_OPS * m * k}, f"B3 M {m} K {k}")
    for c in (1, 64):
        pool = layers.cache_init(1 + 8 * 34, ps, h, d, "bcq4", cfg, device="cuda")
        kk, vv = (torch.randn((8, c, h, d), device="cuda") for _ in range(2))
        if c == 1:
            ids = {"page_ids": torch.arange(1, 25, 3, device="cuda"),
                   "offsets": torch.arange(8, dtype=torch.int32, device="cuda") % ps}
            rows = 8
        else:
            ids = {"chunk_page_ids": torch.arange(1, 33, dtype=torch.int32,
                                                  device="cuda").reshape(8, 4),
                   "chunk_len": torch.full((8,), c, dtype=torch.int32, device="cuda")}
            rows = 8 * 4 * ps
        nbytes = (2 * kk.numel() * 4 + 2 * rows * h * (d // 2 + d // 16 + d // 64)
                  + sum(t.numel() * t.element_size() for t in ids.values()) + cbw + 8)
        meta_held("bcq_page_write", bq.bcq_page_write, (pool, kk, vv, cfg, cb), ids, nbytes,
                  {"f32": ENCODE_OPS * 2 * kk.numel()}, f"B3's writer C {c}")
    m, k, n = EVAL_SEQ * EVAL_BATCH, 768, 3072
    a = ops.quantize(activation(m, k, 235), cb, cfg)
    _, w = linear_case(8, k, n, 236, cb)
    meta_held("bcq_matmul", bm.bcq_matmul,
              (a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed, w.sel_packed, w.inv_scale,
               cb, cb, cfg), {},
              (m + n) * (k // 2 + k // 16 + k // 64 * 4) + 2 * cbw + m * n * 4,
              {"int8": 2 * m * n * k}, f"B4 M {m} K {k} N {n}")
    bh, s_len, d = EVAL_BATCH * 12, EVAL_SEQ, 64
    qkv = [torch.randn((bh, s_len, d), device="cuda").to(torch.bfloat16) for _ in range(3)]
    meta_held("flash_attention", fa.flash_attention_kernel, (*qkv, True), {},
              4 * bh * s_len * d * 2, {"bf16": 4 * d * (s_len * (s_len + 1) // 2) * bh},
              f"B5 ({bh}, {s_len}, {d}) bf16 causal")


def _mesh_train_setup(cfg, mesh):
    """Phase 21's model and batches (bf16 compute, f32 params, 4 × 2048),
    drawn once for (b)–(d): a namespace of the float api, the plain and the
    mesh step, the optimizer config, the params and the batches."""
    from types import SimpleNamespace

    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import adamw

    api = zoo.build(cfg, Runtime(), device="cuda")
    params = api.init_train(0)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    pspecs, _ = train.shardings_for(mesh, api, params)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=EVAL_SEQ, global_batch=EVAL_BATCH, seed=0)
    return SimpleNamespace(
        api=api, plain=train.make_train_step(api, opt_cfg),
        step=train.make_sharded_train_step(api, opt_cfg, mesh, pspecs), opt_cfg=opt_cfg,
        params=params, pspecs=pspecs,
        batches=[batch_at(dcfg, s, device="cuda") for s in range(max(MESH_STEPS, CDP_STEPS) + 1)])


def mesh_equals_plain(st, phase21_ms):
    """(b): ``MESH_STEPS`` mesh steps ≡ as many plain ``make_train_step``
    steps from the same weights, every leaf of params and optimizer state;
    0 collective bytes; both steps timed in turns (mesh, plain, plain,
    mesh).  Returns (mesh ms/step, plain ms/step, the losses)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib, train
    from repro_torch.optim import adamw

    plain, step, params, batches = st.plain, st.step, st.params, st.batches
    mesh_lib.reset_collective_bytes()
    runs = {}
    with train.deterministic():
        for name, fn in (("mesh", step), ("plain", plain)):
            p, o, losses = params, adamw.init_state(params), []
            for s in range(MESH_STEPS):
                p, o, met = fn(p, o, batches[s])
                losses.append(met["loss"])
            runs[name] = (p, o, torch.stack(losses))
    coll = mesh_lib.collective_bytes()
    if coll:
        fail(f"phase 23 (b): the one-rank mesh step moved collective bytes {coll}")
    (pm, om, lm), (pp, op, lp) = runs["mesh"], runs["plain"]
    fa, fb = _flat({"params": pm, "opt": om}), _flat({"params": pp, "opt": op})
    diff = [p for (p, a), (_, b) in zip(fa, fb) if a.dtype != b.dtype or not torch.equal(a, b)]
    if diff or not torch.equal(lm, lp) or len(fa) != len(fb):
        fail(f"phase 23 (b): {MESH_STEPS} mesh steps differ from the plain steps in "
             f"{len(diff)} of {len(fa)} leaves ({diff[:5]}); losses {lm.tolist()} vs {lp.tolist()}")
    opt = adamw.init_state(params)

    def window(fn):
        with train.deterministic():
            fn(params, opt, batches[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIME_STEPS):
                fn(params, opt, batches[0])
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / TIME_STEPS

    ms = {"mesh": [], "plain": []}
    for name in ("mesh", "plain", "plain", "mesh"):
        ms[name].append(window(step if name == "mesh" else plain))
    mesh_ms, plain_ms = float(np.mean(ms["mesh"])), float(np.mean(ms["plain"]))
    print(f"phase 23 (b) mesh step: full-width gpt3_126m, {EVAL_BATCH} × {EVAL_SEQ} tokens, bf16 "
          f"on f32: {MESH_STEPS} steps bit-equal to make_train_step's in all {len(fa)} leaves of "
          f"params and optimizer state, losses {[round(float(v), 4) for v in lm]}; collective "
          f"bytes 0; {mesh_ms:.1f} ms/step against the plain step's {plain_ms:.1f} in turns "
          f"(mesh, plain, plain, mesh: {', '.join(f'{v:.1f}' for v in ms['mesh'][:1] + ms['plain'] + ms['mesh'][1:])}); "
          f"phase 21's CLI step {phase21_ms:.1f} ms/step", flush=True)
    return mesh_ms, plain_ms, [float(v) for v in lm]


def mesh_fake_steps(cfg, mesh, st):
    """(c): ``MESH_FAKE_STEPS`` ``--quant fake`` mesh steps from (b)'s
    weights and the universal codebooks (the train CLI's tree), every B3
    launch held to ``quantize_ref``; returns (B3 launches,
    threshold-search launches, ties)."""
    from repro_torch.core.calibrate import default_universal_codebooks
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import adamw

    api = zoo.build(cfg, Runtime(quant_mode="fake"), device="cuda")
    params = dict(st.params, codebooks=default_universal_codebooks().as_tensor("cuda"))
    pspecs, _ = train.shardings_for(mesh, api, params)
    step = train.make_sharded_train_step(api, st.opt_cfg, mesh, pspecs)
    batches = st.batches

    def run():
        p, o = params, adamw.init_state(params)
        with train.deterministic():
            for s in range(MESH_FAKE_STEPS):
                p, o, met = step(p, o, batches[s])
        return met

    build.reset_counts()
    met, n, ties = hold_fake_route(run, "phase 23 (c)")
    counts = build.counts()
    want = 4 * cfg.n_layers * MESH_FAKE_STEPS
    thr = counts.get("bcq_quantize_thr", 0)
    if counts.get("bcq_quantize", 0) != want or n != want or thr != want - 4 * cfg.n_layers:
        fail(f"phase 23 (c): launches {counts}, {n} held; expected {want} B3 launches, "
             f"{want - 4 * cfg.n_layers} of them the threshold search")
    print(f"phase 23 (c) --quant fake mesh steps: {MESH_FAKE_STEPS} steps, loss "
          f"{float(met['loss']):.4f}, {n} B3 launches held to quantize_ref ({ties} with a "
          f"codebook tie), {thr} of them the threshold search", flush=True)
    return counts["bcq_quantize"], thr, ties


def compressed_steps(mesh, st):
    """(d): ``CDP_STEPS`` steps of ``make_compressed_dp_step`` over the NCCL
    mesh's 'data' axis; then the compressed all-reduce of one step's
    gradients on the card against the same function on the CPU with the
    same gradients and error buffers, every leaf bit for bit.  On one rank
    the axis has size 1 and neither run communicates: the check holds the
    card's int8 arithmetic to the CPU's."""
    import torch

    from repro_torch.launch import mesh as mesh_lib, train
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import compress_grads_tree, init_error_state, \
        make_compressed_psum

    api, params, batches = st.api, st.params, st.batches
    step = train.make_compressed_dp_step(api, st.opt_cfg, mesh, "data")
    p, o, err, losses = params, adamw.init_state(params), init_error_state(params), []
    with train.deterministic():
        for s in range(CDP_STEPS):
            p, o, err, met = step(p, o, err, batches[s])
            losses.append(float(met["loss"]))
        _, grads = train.value_and_grad(api.loss_fn, p, batches[CDP_STEPS])
    psum = make_compressed_psum(mesh, "data")
    g_card, e_card = compress_grads_tree(grads, err, psum)
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    g_cpu, e_cpu = compress_grads_tree(adamw.tree_map(cpu, grads), adamw.tree_map(cpu, err),
                                       make_compressed_psum(mesh_lib.make_mesh((1,), ("data",)),
                                                            "data"))
    fc = _flat({"g": g_card, "e": e_card})
    fh = _flat({"g": g_cpu, "e": e_cpu})
    diff = [p for (p, a), (_, b) in zip(fc, fh) if not torch.equal(a.cpu(), b)]
    if diff:
        fail(f"phase 23 (d): the compressed all-reduce on the card differs from the CPU's in "
             f"{diff[:6]}")
    if not all(np.isfinite(losses)):
        fail(f"phase 23 (d): compressed-DP losses {losses}")
    print(f"phase 23 (d) compressed-DP step over NCCL: {CDP_STEPS} steps, losses "
          f"{[round(v, 4) for v in losses]}; one step's compressed gradients and error buffers "
          f"equal to the CPU's in all {len(fc)} leaves", flush=True)
    return losses


def sharded_decode(cfg, mesh):
    """(e): the sequence-sharded decode at one rank against the gathered
    decode (gpt3_126m, contiguous, bf16 cache, f32 compute)."""
    import dataclasses

    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    rt0 = Runtime(compute_dtype=torch.float32, cache_kind="bf16")
    api0 = zoo.build(cfg, rt0, device="cuda")
    api1 = zoo.build(cfg, dataclasses.replace(rt0, flash_decode=True, mesh=mesh), device="cuda")
    params = api0.init(0)
    g = torch.Generator().manual_seed(23)
    toks = torch.randint(0, cfg.vocab, (DECODE_ROWS, DECODE_PROMPT), generator=g).cuda()
    with torch.no_grad():
        _, c0 = api0.prefill_fn(params, {"tokens": toks}, DECODE_MAX_LEN)
        c1 = {n: t.clone() for n, t in c0.items()}
        r0, _ = api0.decode_fn(params, c0, toks[:, -1:], DECODE_PROMPT)
        mesh_lib.reset_collective_bytes()
        r1, _ = api1.decode_fn(params, c1, toks[:, -1:], DECODE_PROMPT)
    ok, err = held(r1, r0, DECODE_TOL, DECODE_TOL)
    if not ok or mesh_lib.collective_bytes():
        fail(f"phase 23 (e): the sequence-sharded decode differs from the gathered one by {err:.3e}"
             f" (tolerance {DECODE_TOL}) or moved collective bytes")
    # the token's K/V of layer 0 come from its embedding alone, so that layer's cache is
    # bit-equal; a deeper layer's new K/V follow the attention above it, whose combine
    # rounds otherwise, and are held to one bf16 rounding step; every other position is
    # untouched
    pos = DECODE_PROMPT
    kv_err, kv_flips, kv_n = 0.0, 0, 0
    for n in c0:
        if not (torch.equal(c0[n][0], c1[n][0]) and torch.equal(c0[n][:, :, :pos], c1[n][:, :, :pos])
                and torch.equal(c0[n][:, :, pos + 1:], c1[n][:, :, pos + 1:])):
            fail(f"phase 23 (e): the sharded decode's cache write differs from the gathered one's "
                 f"in {n} (layer 0, or a position it must not touch)")
        got, ref = c1[n][1:, :, pos], c0[n][1:, :, pos]
        ok_n, e_n = held(got, ref, DECODE_KV_RTOL, DECODE_TOL)
        if not ok_n:
            fail(f"phase 23 (e): the sharded decode wrote {n}[1:, :, {pos}] {e_n:.3e} away from "
                 f"the gathered one's (rtol {DECODE_KV_RTOL}, atol {DECODE_TOL})")
        kv_err, kv_flips = max(kv_err, e_n), kv_flips + int((got != ref).sum())
        kv_n += got.numel()
    print(f"phase 23 (e) sequence-sharded decode at one rank: {DECODE_ROWS} rows at position "
          f"{DECODE_PROMPT}, logits within {err:.3e} of the gathered decode (tolerance "
          f"{DECODE_TOL}); layer 0's cache and every other position bit-equal; the new K/V of "
          f"layers 1+ within {kv_err:.3e} ({kv_flips} of {kv_n} values one bf16 step apart, "
          f"rtol {DECODE_KV_RTOL})", flush=True)
    return err


def step_roofline(cfg, mesh, mesh_ms):
    """(g): the roofline of phase 21's step shape on the (1, 1) mesh (the
    mesh step traced on meta tensors), against the measured step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline, train
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import adamw

    rt = Runtime()
    api = zoo.build(cfg, rt, device="meta")
    params = zoo.param_shapes(cfg, rt)
    shape = ShapeConfig("phase21", "train", EVAL_SEQ, EVAL_BATCH)
    batch = zoo.input_specs(cfg, rt, shape)
    pspecs, _ = train.shardings_for(mesh, api, params)
    opt = adamw.init_state(params)
    step = train.make_sharded_train_step(api, adamw.AdamWConfig(), mesh, pspecs)
    with roofline.trace() as tr:
        step(params, opt, batch)
    resident = sum(t.numel() * t.element_size() for t in
                   adamw.tree_leaves(params) + adamw.tree_leaves(opt) + list(batch.values()))
    mf = roofline.model_flops(cfg, shape, 1)
    rl = roofline.analyse(tr, mf, resident)
    cli_flops = 6.0 * sum(t.numel() for t in adamw.tree_leaves(params)) * EVAL_BATCH * EVAL_SEQ
    row = rl.row()
    print(f"phase 23 (g) roofline of phase 21's step ({EVAL_BATCH} × {EVAL_SEQ}, (1, 1) mesh, "
          f"H100 data-sheet peaks): t_compute {rl.t_compute * 1e3:.1f} ms "
          f"({ {u: f'{n:.3e}' for u, n in rl.flops_by_unit.items()} } FLOP), t_memory "
          f"{rl.t_memory * 1e3:.1f} ms ({rl.hbm_bytes:.3e} B, unfused), bottleneck "
          f"{rl.bottleneck}, peak memory {rl.peak_mem_bytes / 1e9:.1f} GB; measured "
          f"{mesh_ms:.1f} ms/step: model FLOPs {mf:.3e} a step → {mf / mesh_ms / 1e9:.1f} TFLOP/s "
          f"({mf / mesh_ms / 1e9 / BF16_FLOPS * 1e12:.3f} of the bf16 peak), the CLI's 6·N·tokens "
          f"{cli_flops:.3e} → {cli_flops / mesh_ms / 1e9:.1f} TFLOP/s (PERF.md §5: "
          f"{PHASE21_MODEL_TFLOPS} TFLOP/s); the roofline's bound is "
          f"{rl.t_bound * 1e3 / mesh_ms:.2f} of the measured step", flush=True)
    return {k: row[k] for k in ("t_compute_s", "t_memory_s", "bottleneck", "flops_by_unit",
                                "hbm_bytes_per_dev", "model_flops_per_dev")}


def dryrun_cell():
    """(h): one production dry-run cell in a subprocess."""
    arch, shape, mesh = DRYRUN_CELL
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shape, "--mesh", mesh], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    recs = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    if res.returncode != 0 or len(recs) != 1 or recs[0].get("status") != "ok":
        fail(f"phase 23 (h): the dry-run of {DRYRUN_CELL} exited {res.returncode}: "
             f"{res.stdout[-1500:]} {res.stderr[-1500:]}")
    rec = recs[0]
    print(f"phase 23 (h) dry-run {arch} {shape} on the fake 16 × 16 mesh: status ok, params "
          f"{rec['params_gib_per_dev']} GiB and cache {rec['cache_gib_per_dev']} GiB a device, "
          f"bottleneck {rec['bottleneck']} (t_compute {rec['t_compute_s']:.3e}, t_memory "
          f"{rec['t_memory_s']:.3e}, t_collective {rec['t_collective_s']:.3e} s), peak "
          f"{rec['peak_mem_gib']:.2f} GiB (fits 80 GB: {rec['fits_hbm']})", flush=True)
    return rec


def phase_mesh(cb, smi, phase21_ms):
    """Phase 23: the multi-device layer and the dry-run on one card.
    (a) a one-rank NCCL group and ``derive_mesh()`` = (1, 1); (b) the mesh
    step ≡ the plain step; (c) ``--quant fake`` mesh steps through B3;
    (d) the compressed data-parallel step; (e) the sequence-sharded decode;
    (f) the five kernels' meta branches; (g) the roofline of phase 21's
    step; (h) a production dry-run cell.  Returns (B3's launches in (c),
    the phase's numbers)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_arch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.elastic import derive_mesh

    t_phase = time.perf_counter()
    cfg = get_arch("gpt3_126m")
    device = mesh_lib.init_group("cuda")
    try:
        mesh = derive_mesh()
        sizes = mesh_lib.axis_sizes(mesh)
        if (dist.get_backend(), dist.get_world_size(), sizes) != ("nccl", 1, {"data": 1,
                                                                                "model": 1}):
            fail(f"phase 23 (a): {dist.get_backend()} world of {dist.get_world_size()}, "
                 f"derive_mesh() = {sizes}")
        print(f"phase 23 (a) process group: {dist.get_backend()}, world "
              f"{dist.get_world_size()}, {device}; derive_mesh() = {sizes}", flush=True)
        parts = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            parts[name] = time.perf_counter() - t0
            return out

        st = timed("setup", _mesh_train_setup, cfg, mesh)
        mesh_ms, plain_ms, _ = timed("b", mesh_equals_plain, st, phase21_ms)
        b3, thr, ties = timed("c", mesh_fake_steps, cfg, mesh, st)
        losses = timed("d", compressed_steps, mesh, st)
        del st
        torch.cuda.empty_cache()
        dec_err = timed("e", sharded_decode, cfg, mesh)
        print("phase 23 (f) the kernels' meta branches at phase 10's shapes:", flush=True)
        timed("f", meta_branches, cb)
        torch.cuda.empty_cache()
        roof = timed("g", step_roofline, cfg, mesh, mesh_ms)
        rec = timed("h", dryrun_cell)
    finally:
        dist.destroy_process_group()
    phase_s = time.perf_counter() - t_phase
    print(f"phase 23 summary: mesh step {mesh_ms:.1f} vs plain {plain_ms:.1f} ms/step, bit-equal; "
          f"{b3} B3 launches in the fake mesh steps; compressed-DP losses {losses[0]:.4f} → "
          f"{losses[-1]:.4f}; sharded decode within {dec_err:.2e}; phase 23 {phase_s:.1f} s ("
          f"{', '.join(f'{k} {v:.1f}' for k, v in parts.items())}); {smi}", flush=True)
    return b3, dict(mesh_ms_per_step=mesh_ms, plain_ms_per_step=plain_ms,
                    threshold_search=thr, ties=ties, compressed_dp_losses=losses,
                    sharded_decode_err=dec_err, roofline=roof, parts_s=parts,
                    dryrun={k: rec[k] for k in ("arch", "shape", "status", "bottleneck",
                                                "params_gib_per_dev", "cache_gib_per_dev")},
                    phase_s=phase_s)


# ------------------------------------------------------------------ phase 24
# The paper's LO-BCQ formats as (L_b, L_A, N_c, B, B_c): Table 8's L_b ×
# L_A × N_c ablation (benchmarks/table8_ablation.py), Table 5's W3/W2
# (table5_sub4bit.py), Table 10's INT4/INT6/INT8 codewords
# (table10_codeword.py), then Fig. 4's g128/N_c 16 and the reference's
# kernel tests' g32/L_b 4 and g16/L_b 2.
FMT_PAPER = ([(8, la, nc, 4, 6) for la in (64, 32, 16) for nc in (2, 4, 8, 16)]
             + [(4, 64, 2, 4, 6), (4, 64, 4, 4, 6), (2, 64, 2, 4, 6)]
             + [(8, 128, nc, b, 6) for b, nc in ((3, 4), (3, 8), (2, 4), (2, 8))]
             + [(8, 128, 8, 4, bc) for bc in (4, 6, 8)]
             + [(8, 128, 16, 4, 6), (4, 32, 4, 4, 6), (2, 16, 2, 4, 6)])
# the kernels' formats: the reference kernel tests' five
# (tests/test_kernels.py:19-24, tests/test_fused_linear.py:24-28), then
# g128 at INT8 codewords and at 8 entries
FMT_KERNEL = [(8, 64, 8, 4, 6), (8, 128, 16, 4, 6), (4, 32, 4, 4, 6), (2, 16, 2, 4, 6),
              (8, 64, 16, 4, 6), (8, 128, 8, 4, 8), (8, 128, 8, 3, 6)]
FMT_OPERAND = (256, 4096)  # Table 8's operand
# the quantize CLI's two non-default formats on phase 21's model: Fig. 4's
# g64/Lb8/Nc16 (4.625 bits) and Table 8's iso-bitwidth partner of the
# default, g32/Lb8/Nc4 (4.5 bits)
FMT_CLI = (("--n-codebooks", "16"), ("--array-len", "32", "--n-codebooks", "4"))
FMT_DIR = os.path.join(ROOT, "build", "formats")  # under the ignored build/


def _fmt(spec):
    from repro_torch.core.bcq import BCQConfig

    lb, la, nc, b, bc = spec
    return BCQConfig(block_len=lb, array_len=la, n_codebooks=nc, index_bits=b, codeword_bits=bc)


def _fmt_tag(cfg):
    return f"{cfg.tag()}_B{cfg.index_bits}_Bc{cfg.codeword_bits}"


def fmt_books(specs):
    """Integer codebooks for each format, fitted on the card by
    ``fit_lobcq`` (4 iterations on 4,096 blocks, as the reference's kernel
    tests fit theirs) on one seeded Laplace operand."""
    import torch

    from repro_torch.core.bcq import fit_lobcq
    from repro_torch.serving.prng import prng_key

    data = torch.from_numpy(np.random.default_rng(0).laplace(size=60000).astype(np.float32)).cuda()
    t0 = time.perf_counter()
    books = {}
    for spec in specs:
        cfg = _fmt(spec)
        books[spec] = fit_lobcq(data, cfg, key=prng_key(0), iters=4, max_blocks=4096).as_tensor(
            "cuda")
    torch.cuda.synchronize()
    print(f"phase 24 codebooks: {len(books)} formats fitted on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return books


def _fmt_entry(entry, spec, shape, t):
    entry.setdefault("timings", []).append(
        {"format": _fmt_tag(_fmt(spec)), "shape": shape,
         **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}})


def fmt_fake_quant(books, out):
    """(1) ``bcq.fake_quant`` (B3's quantize form + a torch decode) on the
    card at the 25 formats, on Table 8's (256, 4096) operand: bit for bit
    against ``fake_quant_plain`` on the card, and each NMSE computed on the
    CPU from the card's values bit-equal to the plain route's on the CPU;
    B3 timed (CUDA events) beside its bound."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_quantize as bq
    from repro_torch.kernels import build

    g = np.random.default_rng(24)
    x = g.standard_normal(FMT_OPERAND).astype(np.float32)
    x = np.where(g.random(FMT_OPERAND) < 0.005, x * 20.0, x).astype(np.float32)
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).cuda()
    m, k = FMT_OPERAND
    rows = []
    for spec in FMT_PAPER:
        cfg, cb = _fmt(spec), books[spec]
        build.reset_counts()
        got = bcq.fake_quant(xg, cb, cfg)
        torch.cuda.synchronize()
        counts = build.counts()
        route = bcq.kernel_route(cfg)
        thr = counts.get("bcq_quantize_thr", 0)
        if counts.get("bcq_quantize") != 1 or thr != (0 if route.table else 1):
            fail(f"phase 24 fake_quant at {_fmt_tag(cfg)}: launches {counts}")
        if not torch.equal(got, bcq.fake_quant_plain(xg, cb, cfg)):
            fail(f"phase 24: fake_quant at {_fmt_tag(cfg)} differs from fake_quant_plain on the "
                 "card")
        nmse = float(bcq.quantization_nmse(xc, got.cpu()))
        plain = float(bcq.quantization_nmse(xc, bcq.fake_quant_plain(xc, cb.cpu(), cfg)))
        if np.float32(nmse).tobytes() != np.float32(plain).tobytes():
            fail(f"phase 24: the NMSE at {_fmt_tag(cfg)} is {nmse!r} from the card's values, "
                 f"{plain!r} from the CPU's plain route")
        s_x = bcq.tensor_scale(xg, cfg)
        ms = cuda_ms(lambda: bq.bcq_quantize(xg, cb, s_x, cfg), iters=20)
        plain_ms = cuda_ms(lambda: bcq.fake_quant_plain(xg, cb, cfg), iters=3, warmup=1)
        nbytes, work = bq.quantize_cost(m, k, cfg, route)
        bound, by = _bound(nbytes, (work["f32"], F32_FLOPS))
        t = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
        _fmt_entry(out["bcq_quantize"], spec, f"M {m} K {k}", t)
        rows.append((cfg, nmse, ms, bound))
        print(f"phase 24 fake_quant {_fmt_tag(cfg):22s} ({cfg.bitwidth():.4f} bits): NMSE "
              f"{nmse:.6e} (= the CPU plain route's, bit for bit), kernel route ≡ plain; B3 "
              f"{ms:.4f} ms (CUDA events; {'table' if route.table else 'threshold search'}) vs bound "
              f"{bound:.5f} ms by {by}, plain fake_quant {plain_ms:.3f} ms", flush=True)
    out["bcq_quantize"]["formats"] = [_fmt_tag(c) for c, *_ in rows]
    return rows


def _fmt_time(what, fn, ref_fn, tol_abs, rtol, nbytes, work, iters=30):
    """One kernel call at a format: held to its plain version, timed
    (CUDA events) with its plain version, and its bound."""
    got, ref = fn(), ref_fn()
    ok, err = held(got, ref, rtol, tol_abs(ref))
    if not ok:
        fail(f"phase 24: {what} disagrees with its plain version: max|err| {err:.3e}")
    bound, by = _bound(nbytes, *work)
    return {"ms": cuda_ms(fn, iters=iters), "plain_ms": cuda_ms(ref_fn, iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by, "err": err, "out": got}


def fmt_kernels(books, out):
    """(2) B1 (M 8 and 512, 768 → 3072), B1s (E 4 × C 64), B4 (512 × 768 →
    3072), the page writer and B2 (bcq4) at decode (8 rows × 12 heads of
    64) and a 64-token chunk, at the 7 kernel formats: each held to its
    plain version at phase 10's tolerances, B1s ≡ per-expert B1 and B4 ≡ B1
    bit for bit, timed (CUDA events) beside the bound of its corrected
    cost.  Returns the launches by kernel."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_linear as bl
    from repro_torch.kernels import bcq_matmul as bm
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import fused_linear_experts_ref, fused_linear_ref, matmul_ref

    rel = lambda ref: LINEAR_TOL * float(ref.abs().max())  # noqa: E731
    totals = {}
    k, n = 768, 3072
    for spec in FMT_KERNEL:
        cfg, cb = _fmt(spec), books[spec]
        tag = _fmt_tag(cfg)
        torch.cuda.synchronize()
        build.reset_counts()
        lin = {}
        for m in (8, 512):
            x, w = linear_case(m, k, n, m, cb, cfg)
            s_x = bcq.tensor_scale(x, cfg)
            args = (x, w.idx_packed, w.sel_packed, w.inv_scale, cb)
            nbytes, work = bl.linear_cost(1, m, k, n, cfg)
            t = lin[m] = _fmt_time(f"B1 at {tag} M {m}", lambda: bl.bcq_linear(*args, s_x, cfg),
                                   lambda: fused_linear_ref(*args, cfg, s_x, valid_k=k), rel,
                                   LINEAR_TOL, nbytes, ((work["int8"], INT8_OPS),
                                                        (work["f32"], F32_FLOPS)))
            _fmt_entry(out["bcq_linear"], spec, f"M {m} K {k} N {n}", t)
        a = ops.quantize(x, cb, cfg)
        margs = (a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed, w.sel_packed,
                 w.inv_scale, cb, cb, cfg)
        nbytes, work = bm.matmul_cost(512, k, n, cfg)
        t4 = _fmt_time(f"B4 at {tag}", lambda: bm.bcq_matmul(*margs), lambda: matmul_ref(*margs),
                       rel, LINEAR_TOL, nbytes, ((work["int8"], INT8_OPS),), iters=20)
        if not torch.equal(t4["out"], lin[512]["out"]):
            fail(f"phase 24: B4 at {tag} differs from B1 on the same codes (the two routes)")
        _fmt_entry(out["bcq_matmul"], spec, f"M 512 K {k} N {n}", t4)
        e, c = 4, 64
        xs, ws = zip(*(linear_case(c, k, n, 40 + i, cb, cfg) for i in range(e)))
        xe = torch.stack(xs)
        st = [torch.stack([getattr(w, f) for w in ws])
              for f in ("idx_packed", "sel_packed", "inv_scale")]
        s_e = bcq.tensor_scale(xe, cfg)
        nbytes, work = bl.linear_cost(e, c, k, n, cfg)
        ts = _fmt_time(f"B1s at {tag}", lambda: bl.bcq_linear_experts(xe, *st, cb, s_e, cfg),
                       lambda: fused_linear_experts_ref(xe, *st, cb, cfg, s_e), rel, LINEAR_TOL,
                       nbytes, ((work["int8"], INT8_OPS), (work["f32"], F32_FLOPS)), iters=20)
        per = torch.stack([bl.bcq_linear(xe[i], *(t[i] for t in st), cb, s_e, cfg)
                           for i in range(e)])
        if not torch.equal(ts["out"], per):
            fail(f"phase 24: B1s at {tag} differs from per-expert B1 launches")
        _fmt_entry(out["bcq_linear_experts"], spec, f"E {e} C {c} K {k} N {n}", ts)
        wr = {nm: _write_times(cb, c_, 70 + c_, cfg=cfg, profile=False)
              for nm, c_ in (("decode", 1), ("chunk", 64))}
        kv_dec = [p + GEN for p in PROMPT_LENS]
        ga = {"decode": _gather_times(cb, 1, kv_dec, 5, cfg=cfg, profile=False),
              "chunk": _gather_times(cb, 64, [c_ + 64 for c_ in PROMPT_LENS], 6, cfg=cfg,
                                     profile=False)}
        for nm in ("decode", "chunk"):
            _fmt_entry(out["bcq_quantize"], spec, f"writer {nm}: B 8 C "
                       f"{1 if nm == 'decode' else 64} H 12 D 64 f32", wr[nm])
            _fmt_entry(out["page_gather"], spec, f"{nm}: B 8 C {1 if nm == 'decode' else 64} "
                       "H 12 D 64", ga[nm])
        torch.cuda.synchronize()
        counts = build.counts()
        for kk, v in counts.items():
            totals[kk] = totals.get(kk, 0) + v
        worst = max(lin[8]["err"], lin[512]["err"], ts["err"])
        out["bcq_linear"]["max_abs_err"] = max(out["bcq_linear"].get("max_abs_err", 0.0),
                                               lin[8]["err"], lin[512]["err"])
        out["bcq_linear_experts"]["max_abs_err"] = max(
            out["bcq_linear_experts"].get("max_abs_err", 0.0), ts["err"])
        out["bcq_matmul"]["max_abs_err"] = max(out["bcq_matmul"].get("max_abs_err", 0.0), t4["err"])
        out["page_gather"]["max_abs_err"] = max(out["page_gather"].get("max_abs_err", 0.0),
                                                ga["decode"]["err"], ga["chunk"]["err"])
        f = lambda t: (f"{t['ms']:.4f} ms (bound {t['bound_ms']:.5f} "  # noqa: E731
                       f"by {t['bound_by']})")
        print(f"phase 24 kernels at {tag}: B1 M 8 {f(lin[8])}, M 512 {f(lin[512])}; B1s E 4 × C "
              f"64 {f(ts)} ≡ per-expert B1; B4 M 512 {f(t4)} ≡ B1; writer decode "
              f"{f(wr['decode'])}, "
              f"chunk {f(wr['chunk'])} (bytes = plain); B2 decode {f(ga['decode'])}, chunk "
              f"{f(ga['chunk'])}; worst B1/B1s max|err| {worst:.3e}; launches {counts}", flush=True)
    for name in ("bcq_linear", "bcq_linear_experts", "bcq_matmul", "page_gather"):
        out[name]["formats"] = [_fmt_tag(_fmt(s)) for s in FMT_KERNEL]
    return totals


# K a whole number of arrays but not of the GEMM's 64-wide steps (the
# wrappers pad it with zero arrays): (K, format); L_A 16 at K 112 (Qwen2's
# smoke width) and 80, L_A 32 at K 96
FMT_ODD_K = ((112, (2, 16, 2, 4, 6)), (80, (2, 16, 2, 4, 6)), (96, (4, 32, 4, 4, 6)))


def fmt_library(out):
    """One PyTorch call per shape of (2) computing the same product in bf16
    (``torch.matmul`` for B1 and B4, ``torch.bmm`` for B1s), timed with
    CUDA events — the library yardstick of rows 1f, 1sf and 4f; the port
    calls neither."""
    import torch

    k, n = 768, 3072
    g = torch.Generator(device="cuda").manual_seed(24)
    w = torch.randn((k, n), generator=g, device="cuda").to(torch.bfloat16)
    lib = {}
    for m in (8, 512):
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        lib[f"M {m} K {k} N {n}"] = cuda_ms(lambda: torch.matmul(x, w))
    xe = torch.randn((4, 64, k), generator=g, device="cuda").to(torch.bfloat16)
    we = torch.randn((4, k, n), generator=g, device="cuda").to(torch.bfloat16)
    lib[f"E 4 C 64 K {k} N {n}"] = cuda_ms(lambda: torch.bmm(xe, we))
    out["bcq_linear"]["library_ms"] = {sh: t for sh, t in lib.items() if sh.startswith("M")}
    out["bcq_matmul"]["library_ms"] = {sh: t for sh, t in lib.items() if sh.startswith("M 512")}
    out["bcq_linear_experts"]["library_ms"] = {sh: t for sh, t in lib.items()
                                               if sh.startswith("E")}
    print("phase 24 library yardsticks (bf16, CUDA events): "
          + ", ".join(f"{sh} {t:.4f} ms" for sh, t in lib.items()), flush=True)
    return lib


def fmt_odd_k(books, out):
    """(2′) B1 at M 8 and 512, B1s at E 4 × C 64 and B4 at M 512, N 3072,
    at each ``FMT_ODD_K`` K: held to the plain versions at phase 10's
    tolerance, B4 ≡ B1 and B1s ≡ per-expert B1 bit for bit, the launches of
    the held calls counted exactly (B1 2 + 4 per-expert, B1s 1, B3 1 on
    its threshold search, B4 1 a K), each timed (CUDA events) beside its plain version, its bound
    (the work at the unpadded K) and the bf16 library call.  Returns the
    launches by kernel."""
    import torch

    from repro_torch.core import bcq
    from repro_torch.kernels import bcq_linear as bl
    from repro_torch.kernels import bcq_matmul as bm
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import fused_linear_experts_ref, fused_linear_ref, matmul_ref

    rel = lambda ref: LINEAR_TOL * float(ref.abs().max())  # noqa: E731
    n, e, c = 3072, 4, 64
    want = {"bcq_linear": 6, "bcq_linear_experts": 1, "bcq_quantize": 1, "bcq_quantize_thr": 1,
            "bcq_matmul": 1}
    totals, rows = {}, {name: [] for name in ("bcq_linear", "bcq_linear_experts", "bcq_matmul")}
    worst = {}
    for k, spec in FMT_ODD_K:
        cfg, cb = _fmt(spec), books[spec]
        tag = f"{_fmt_tag(cfg)} K {k}"
        cases = {m: linear_case(m, k, n, 300 + m + k, cb, cfg) for m in (8, 512)}
        xs, ws = zip(*(linear_case(c, k, n, 340 + i + k, cb, cfg) for i in range(e)))
        xe = torch.stack(xs)
        st = [torch.stack([getattr(w, f) for w in ws])
              for f in ("idx_packed", "sel_packed", "inv_scale")]
        s_e = bcq.tensor_scale(xe, cfg)
        torch.cuda.synchronize()
        build.reset_counts()
        got, errs = {}, {}
        for m, (x, w) in cases.items():
            s_x = bcq.tensor_scale(x, cfg)
            args = (x, w.idx_packed, w.sel_packed, w.inv_scale, cb)
            got[m] = bl.bcq_linear(*args, s_x, cfg)
            ref = fused_linear_ref(*args, cfg, s_x, valid_k=k)
            ok, errs[f"B1 M {m}"] = held(got[m], ref, LINEAR_TOL, rel(ref))
            if not ok:
                fail(f"phase 24: B1 at {tag} M {m} disagrees with its plain version: max|err| "
                     f"{errs[f'B1 M {m}']:.3e}")
        x, w = cases[512]
        a = ops.quantize(x, cb, cfg, s_x=bcq.tensor_scale(x, cfg))
        margs = (a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed, w.sel_packed,
                 w.inv_scale, cb, cb, cfg)
        two = bm.bcq_matmul(*margs)
        ref = matmul_ref(*margs)
        ok, errs["B4"] = held(two, ref, LINEAR_TOL, rel(ref))
        if not ok or not torch.equal(two, got[512]):
            fail(f"phase 24: B4 at {tag} disagrees with its plain version (max|err| "
                 f"{errs['B4']:.3e}) or with B1 on the same codes")
        stacked = bl.bcq_linear_experts(xe, *st, cb, s_e, cfg)
        ref = fused_linear_experts_ref(xe, *st, cb, cfg, s_e)
        ok, errs["B1s"] = held(stacked, ref, LINEAR_TOL, rel(ref))
        per = torch.stack([bl.bcq_linear(xe[i], *(t[i] for t in st), cb, s_e, cfg)
                           for i in range(e)])
        if not ok or not torch.equal(stacked, per):
            fail(f"phase 24: B1s at {tag} disagrees with its plain version (max|err| "
                 f"{errs['B1s']:.3e}) or with per-expert B1 launches")
        torch.cuda.synchronize()
        counts = {kk: v for kk, v in build.counts().items() if v}
        if counts != want:
            fail(f"phase 24: the held calls at {tag} launched {counts}, expected {want}")
        for kk, v in counts.items():
            totals[kk] = totals.get(kk, 0) + v
        timed = {}
        for m, (x, w) in cases.items():
            s_x = bcq.tensor_scale(x, cfg)
            args = (x, w.idx_packed, w.sel_packed, w.inv_scale, cb)
            nbytes, work = bl.linear_cost(1, m, k, n, cfg)
            timed[f"B1 M {m}"] = ("bcq_linear", f"M {m} K {k} N {n}", _fmt_time(
                f"B1 at {tag} M {m}", lambda: bl.bcq_linear(*args, s_x, cfg),
                lambda: fused_linear_ref(*args, cfg, s_x, valid_k=k), rel, LINEAR_TOL, nbytes,
                ((work["int8"], INT8_OPS), (work["f32"], F32_FLOPS))))
        nbytes, work = bm.matmul_cost(512, k, n, cfg)
        timed["B4"] = ("bcq_matmul", f"M 512 K {k} N {n}", _fmt_time(
            f"B4 at {tag}", lambda: bm.bcq_matmul(*margs), lambda: matmul_ref(*margs), rel,
            LINEAR_TOL, nbytes, ((work["int8"], INT8_OPS),), iters=20))
        nbytes, work = bl.linear_cost(e, c, k, n, cfg)
        timed["B1s"] = ("bcq_linear_experts", f"E {e} C {c} K {k} N {n}", _fmt_time(
            f"B1s at {tag}", lambda: bl.bcq_linear_experts(xe, *st, cb, s_e, cfg),
            lambda: fused_linear_experts_ref(xe, *st, cb, cfg, s_e), rel, LINEAR_TOL, nbytes,
            ((work["int8"], INT8_OPS), (work["f32"], F32_FLOPS)), iters=20))
        g = torch.Generator(device="cuda").manual_seed(k)
        wb = torch.randn((k, n), generator=g, device="cuda").to(torch.bfloat16)
        web = torch.randn((e, k, n), generator=g, device="cuda").to(torch.bfloat16)
        xb = {m: cases[m][0].to(torch.bfloat16) for m in (8, 512)}
        xeb = xe.to(torch.bfloat16)
        lib_k = {f"B1 M {m}": cuda_ms(lambda: torch.matmul(xb[m], wb)) for m in (8, 512)}
        lib_k["B4"] = lib_k["B1 M 512"]
        lib_k["B1s"] = cuda_ms(lambda: torch.bmm(xeb, web))
        for what, (name, shape, t) in timed.items():
            rows[name].append({"format": _fmt_tag(cfg), "shape": shape, "library_ms": lib_k[what],
                               **{kk: t[kk] for kk in ("ms", "plain_ms", "bound_ms", "bound_by")}})
            worst[name] = max(worst.get(name, 0.0), t["err"], *(v for kk, v in errs.items()
                                                               if kk.startswith(what)))
        f = lambda t: f"{t['ms']:.4f} ms (bound {t['bound_ms']:.5f} by {t['bound_by']})"  # noqa: E731
        print(f"phase 24 odd K at {tag} (padded to {build.pad_k(k)}): B1 M 8 "
              f"{f(timed['B1 M 8'][2])}, M 512 {f(timed['B1 M 512'][2])}; B4 M 512 "
              f"{f(timed['B4'][2])} ≡ B1; B1s E 4 × C 64 {f(timed['B1s'][2])} ≡ per-expert B1; "
              f"bf16 library {lib_k['B1 M 8']:.4f} / {lib_k['B1 M 512']:.4f} / "
              f"{lib_k['B1s']:.4f} ms; max|err| "
              + ", ".join(f"{kk} {v:.3e}" for kk, v in errs.items())
              + f"; held launches {counts}", flush=True)
    for name, r in rows.items():
        out[name]["odd_k"] = {"rows": r, "max_abs_err": worst.get(name, 0.0),
                              "held_launches": totals.get(name, 0)}
        out[name]["max_abs_err"] = max(out[name].get("max_abs_err", 0.0), worst.get(name, 0.0))
    out["bcq_quantize"]["odd_k_held_launches"] = totals.get("bcq_quantize", 0)
    return totals


def fmt_serve(flags, train_ck, prompts, ptq_losses, smi):
    """(3) Phase 21's checkpoint through the quantize CLI on the card at a
    non-default format (``flags``), the packed artifact served through
    PagedEngine with bcq4 pages in the same format on phase 4's workload:
    kernels (graph depth 2, launch counts exact) vs plain (eager depth 1)
    — their logits within the plain path's noise floor at B1's tolerance,
    their tokens under the margin rule with that floor as its tolerance
    (``phase_logits(margin="floor")``) —, the last layer's B1, B2 and
    writer launches of
    the first step and a steady tick held to plain, and the held-out W4A4
    loss beside phase 17's.  Returns (the served run's launches, worst
    held errors, a summary)."""
    import dataclasses
    import math
    import shutil
    from types import SimpleNamespace

    import torch

    from repro_torch.checkpoint.manager import load_pytree
    from repro_torch.configs.base import get_arch
    from repro_torch.core import ptq
    from repro_torch.core.bcq import BCQConfig
    from repro_torch.data.pipeline import DataConfig, eval_stream
    from repro_torch.launch import quantize
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.generate import Request, greedy_agreement

    t0 = time.perf_counter()
    cfg = get_arch("gpt3_126m")
    out = os.path.join(FMT_DIR, "_".join(f.strip("-") for f in flags))
    shutil.rmtree(out, ignore_errors=True)
    totals = {}
    manifest, counts = _counted(lambda: quantize.main(["--ckpt", train_ck, "--out", out, *flags]),
                                totals)
    bcfg = BCQConfig(array_len=manifest["bcq"]["L_A"], n_codebooks=manifest["bcq"]["N_c"])
    label = f"phase 24 [{bcfg.tag()}]"
    _expect(counts, {"bcq_quantize": 6, "bcq_quantize_thr": 6}, "quantize CLI", label)
    to_cuda = lambda t: ({k: to_cuda(v) for k, v in t.items()} if isinstance(t, dict)  # noqa: E731
                         else t.to("cuda"))
    fake = to_cuda(load_pytree(os.path.join(out, "weights_w4_fake.npz")))
    params = ptq.packed_from_artifact(
        fake, to_cuda(load_pytree(os.path.join(out, "weights_w4_packed.npz"))))
    cli_s = time.perf_counter() - t0
    print(f"{label} quantize CLI {' '.join(flags)} on phase 21's checkpoint: {cli_s:.2f} s, "
          f"{manifest['bcq']['bits']} bits a weight (Eq. 9), 6 B3 launches (threshold search)",
          flush=True)
    rt = Runtime(quant_mode="packed", bcq_cfg=bcfg, compute_dtype=torch.float32,
                 cache_kind="bcq4", paged_kernel=True)
    api_k = zoo.build(cfg, rt, device="cuda")
    api_p = zoo.build(cfg, dataclasses.replace(rt, paged_kernel=False, fused_linear=False),
                      device="cuda")
    model = SimpleNamespace(api=api_k, params=params, max_len=MOE_MAX_LEN)

    def served(api, graphs, depth):
        eng = PagedEngine(api, params, n_slots=len(prompts), max_len=MOE_MAX_LEN, page_size=16,
                          prefill_chunk=64, chunked_prefill=True, prefix_caching=False,
                          device="cuda", pipeline_depth=depth, cuda_graphs=graphs)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=GEN - 1))
        fin, _ = eng.run_to_completion()
        return eng, {r.rid: r for r in fin}

    (eng_k, fin_k), counts = _counted(lambda: served(api_k, True, 2), totals)
    st = eng_k.stats
    passes = st["decode_ticks"] + st["prefill_launches"]
    expect = _zoo_counts_ok(counts, passes, cfg, "graph depth 2", label)
    wall = 1e3 * st["t_decode_s"] / max(st["decode_ticks"], 1)
    eng_p, plain = served(api_p, False, 1)
    if sorted(fin_k) != sorted(plain) or any(len(r.out) != GEN for r in fin_k.values()):
        fail(f"{label}: the engines did not finish every request with {GEN} tokens")
    tol = phase_logits(SimpleNamespace(api=api_k, params=params),
                       SimpleNamespace(api=api_p, params=params), prompts,
                       [plain[i].out[0] for i in sorted(plain)], float_check=False,
                       margin="floor")
    agree = greedy_agreement(plain, fin_k, tol)
    if not agree["ok"]:
        fail(f"{label}: kernels vs plain tokens disagree beyond the margin rule: {agree}")
    worst, held_n = zoo_launch_checks(model, prompts, label)
    dc = DataConfig(vocab=cfg.vocab, seq_len=EVAL_SEQ, global_batch=EVAL_BATCH)
    batches = list(eval_stream(dc, EVAL_BATCHES, device="cuda"))
    api_e = zoo.build(cfg, Runtime(compute_dtype=torch.bfloat16, flash_kernel=True,
                                   quant_mode="packed", bcq_cfg=bcfg), device="cuda")
    (losses, ms), counts_ev = _counted(lambda: _eval_losses(api_e, params, batches), totals)
    _expect(counts_ev, {"bcq_linear": 6 * cfg.n_layers * len(batches),
                        "flash_attention": cfg.n_layers * len(batches)}, "evaluation", label)
    loss = sum(losses) / len(losses)
    if not math.isfinite(loss):
        fail(f"{label}: non-finite held-out loss {losses}")
    print(f"{label}: PagedEngine (bcq4 pages in {bcfg.tag()}) at graph depth 2: launches "
          f"{expect} over {passes} passes; decode {wall:.2f} ms/tick (host clock over the "
          f"run's {st['decode_ticks']} ticks); kernels vs plain "
          f"(eager depth 1) tokens {agree} (margin rule, logit tol {tol:.3e}: the plain path's "
          f"noise floor at B1's tolerance; {agree['tie_flips']} W4A4 flips inside it); "
          f"held-out W4A4 loss (packed artifact, {EVAL_BATCHES} × {EVAL_BATCH} × {EVAL_SEQ} "
          f"tokens) {loss:.6f} ({math.exp(loss):.3f} ppl) vs phase 17's default g64_Lb8_Nc8 "
          f"packed {ptq_losses.get('packed', float('nan')):.6f}, fake "
          f"{ptq_losses.get('fake bcq', float('nan')):.6f} (printed, not gated); "
          f"{time.perf_counter() - t0:.1f} s; {smi}", flush=True)
    del eng_k, eng_p, model, api_k, api_p, api_e, params, fake
    _free_model()
    return totals, worst, {"format": bcfg.tag(), "bits": manifest["bcq"]["bits"],
                           "loss": loss, "ptq_default_loss": ptq_losses.get("packed"),
                           "tick_wall_ms": wall, "passes": passes, "held": held_n}


def phase_formats(smi, train_ck, ptq_losses):
    """Phase 24: every LO-BCQ format on the card.  (1) ``bcq.fake_quant`` at
    the paper's 25 formats; (2) B1, B1s, B4, the page writer and B2 at 7;
    (3) full-width gpt3_126m quantized by the CLI in two non-default
    formats and served.  Returns (launches by kernel of (3), the main
    path's run; the ``formats`` entries by kernel; worst errors)."""
    import torch

    from repro_torch.configs.base import get_arch

    t_phase = time.perf_counter()
    books = fmt_books(sorted(set(FMT_PAPER) | set(FMT_KERNEL)))
    entries = {n: {} for n in ("bcq_linear", "bcq_linear_experts", "page_gather",
                               "bcq_quantize", "bcq_matmul")}
    fmt_fake_quant(books, entries)
    kern = fmt_kernels(books, entries)
    fmt_library(entries)
    odd = fmt_odd_k(books, entries)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, get_arch("gpt3_126m").vocab, n) for n in PROMPT_LENS]
    served, worst = {}, {}
    for flags in FMT_CLI:
        counts, w, summary = fmt_serve(flags, train_ck, prompts, ptq_losses, smi)
        for kk, v in counts.items():
            served[kk] = served.get(kk, 0) + v
        worst = {kk: max(worst.get(kk, 0.0), v) for kk, v in w.items()}
        entries["bcq_linear"].setdefault("served", []).append(summary)
    entries["page_gather"]["max_abs_err"] = max(entries["page_gather"].get("max_abs_err", 0.0),
                                                worst.get("page_gather", 0.0))
    entries["bcq_linear"]["max_abs_err"] = max(entries["bcq_linear"].get("max_abs_err", 0.0),
                                               worst.get("bcq_linear", 0.0))
    torch.cuda.synchronize()
    print(f"phase 24 summary: 25 formats through fake_quant bit for bit, 7 through B1, B1s, B4, "
          f"the writer and B2 (launches {kern}), B1, B1s and B4 at K 112, 80 and 96 (held "
          f"launches {odd}), 2 CLI formats served (launches {served}); "
          f"phase 24 {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return served, entries


# ------------------------------------------------------------------ phase 25
EXAMPLES_DIR = os.path.join(ROOT, "examples")
# the examples' reduced steps on the card: (name, argv)
EXAMPLE_RUNS = (("torch_quickstart", []),
                ("torch_calibrate_and_eval", ["--steps", "30"]),
                ("torch_serve_w4a4", ["--steps", "30", "--gen", "12"]))


def phase_examples(smi):
    """Phase 25: the three examples' ``main`` in this process on the card
    at reduced steps; each must finish, and the quickstart's kernel
    results (the two-launch GEMM, the fused linear) must equal its plain
    ones (the same codes: the two routes bit for bit; each against its
    plain version at B1's tolerance)."""
    import importlib.util

    import torch

    t_phase = time.perf_counter()
    outs = {}
    for name, argv in EXAMPLE_RUNS:
        path = os.path.join(EXAMPLES_DIR, f"{name}.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        outs[name] = mod.main(argv)
        torch.cuda.synchronize()
        print(f"phase 25 example {name} {' '.join(argv)}: finished in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    qs = outs["torch_quickstart"]
    if qs["gemm"].device.type != "cuda" or not torch.equal(qs["gemm"], qs["fused"]):
        fail("phase 25: the quickstart's fused linear and two-launch GEMM differ on the card")
    for key in ("gemm", "fused"):
        ok, err = held(qs[key], qs[f"{key}_plain"], LINEAR_TOL,
                       LINEAR_TOL * float(qs[f"{key}_plain"].abs().max()))
        if not ok:
            fail(f"phase 25: the quickstart's {key} differs from its plain version: {err:.3e}")
    rows = outs["torch_calibrate_and_eval"]["rows"]
    if not all(np.isfinite(r[2]) for r in rows):
        fail(f"phase 25: non-finite perplexities {rows}")
    print(f"phase 25 summary: quickstart NMSE {qs['nmse']['LO-BCQ']:.5f}, kernels ≡ plain; "
          f"calibrate_and_eval {[(r[0], round(r[2], 3)) for r in rows]}; serve_w4a4 agreement "
          f"{outs['torch_serve_w4a4']['agreement']}; phase 25 "
          f"{time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)


# ------------------------------------------------------------------ phase 26
# the four families' training at full width: (arch, layers kept — None:
# whole —, batch, tokens a row).  Moonlight-16B-A3B keeps 2 of its 48
# layers and RecurrentGemma-9B one period (rec, rec, attn) of its 38, for
# the card's memory (f32 params with the step's out-of-place AdamW: ~28 B a
# parameter at the update) and the script's time; widths whole.  Whisper's
# decoder at its 448-token context over phase 20's 1,500 stub frames.
FAM_TRAIN = (("moonshot_v1_16b", 2, 2, 512), ("mamba2_130m", None, 2, 512),
             ("recurrentgemma_9b", 3, 2, 512), ("whisper_base", None, 2, 448))
FAM_FLOAT_STEPS = 3


def fam_fake_sites(cfg):
    """B3 launches of one fake-quant forward: one a quantized linear input
    (a shared input — QKV, a gate pair, K and V of the cross attention —
    once).  MoE: QKV, the attention output, the experts' wi, wg and wo
    inputs; SSM: in_proj, out_proj; a RG-LRU block (proj_x + gate),
    (gate_a + gate_x), proj_out, the MLP's two; an attention block QKV, wo
    and the MLP's two; Whisper's encoder layer 4, decoder layer 7 (self QKV
    and output, cross Q, cross K + V over the encoder output, cross output,
    the MLP's two)."""
    fam, n = cfg.family, cfg.n_layers
    if fam == "moe":
        return 5 * n
    if fam == "ssm":
        return 2 * n
    if fam == "hybrid":
        pat = cfg.hybrid.pattern
        n_attn = sum(pat[i % len(pat)] == "attn" for i in range(n))
        return 5 * (n - n_attn) + 4 * n_attn
    if fam == "encdec":
        return 4 * cfg.n_encoder_layers + 7 * n
    raise ValueError(fam)


def _bit_sums(tree):
    """Each leaf's per-row sums of its bit patterns as integers (int64:
    exact for 32-bit leaves; a 0-d leaf its one value), in sorted-key
    order: two trees with equal sums agree bit for bit but for flips that
    cancel in a row."""
    import torch

    out = []
    for _, t in _flat(tree):
        bits = t.detach().reshape(t.shape[0] if t.ndim else 1, -1)
        bits = bits.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[bits.element_size()])
        out.append(bits.sum(dim=1, dtype=torch.int64))
    return out


def fam_train(arch, n_layers, batch_rows, seq, smi):
    """One family's training at full width on the card through the train
    CLI's ``make_train_step`` (its Runtime: bf16 compute on f32 params; its
    AdamW; the deterministic algorithms on): ``FAM_FLOAT_STEPS`` float
    steps from ``init_train(0)`` on the CLI's data (``batch_at``; Whisper's
    rows over the stub frames), step 1 run twice from the same state and
    equal bit for bit (loss, grad_norm and every leaf of params and
    moments by ``_bit_sums``), every loss and grad_norm finite, no kernel
    launched; then one ``quant_mode="fake"`` step from the trained state
    plus the universal codebooks, B3's launches counted exactly
    (``fam_fake_sites``), and its loss and gradients through B3's route
    held to the plain route's (``fake_grads_equal``, every launch held to
    ``quantize_ref``).  Returns its numbers."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core.calibrate import default_universal_codebooks
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.launch.serve import _stub_frames
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import adamw

    t_fam = time.perf_counter()
    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    label = f"phase 26 [{arch}]"
    rt = Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.float32)  # the CLI's
    api = zoo.build(cfg, rt, device="cuda")
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=FAM_FLOAT_STEPS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch_rows, seed=0)
    frames = None
    if cfg.family == "encdec":
        frames = torch.from_numpy(_stub_frames(cfg)).cuda().expand(batch_rows, -1, -1)

    def batch(i):
        b = dict(batch_at(dcfg, i, device="cuda"))
        if frames is not None:
            b["frames"] = frames
        return b

    t0 = time.perf_counter()
    params = api.init_train(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in _flat(params))
    opt = adamw.init_state(params)
    step = train.make_train_step(api, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    ms, losses, norms = [], [], []
    with train.deterministic():
        t0 = time.perf_counter()
        p1, o1, m1 = step(params, opt, batch(0))
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        sums = _bit_sums({"params": p1, "opt": o1})
        metrics = (m1["loss"].clone(), m1["grad_norm"].clone())
        del p1, o1, m1
        p1, o1, m1 = step(params, opt, batch(0))  # step 1 again, from the same state
        if not (torch.equal(metrics[0], m1["loss"]) and torch.equal(metrics[1], m1["grad_norm"])
                and all(torch.equal(a, b) for a, b in zip(sums, _bit_sums({"params": p1, "opt": o1})))):
            fail(f"{label}: step 1 run twice from the same state differs")
        del params, opt, sums
        params, opt = p1, o1
        del p1, o1  # the step-1 state lives on as params, opt only: the loop frees it
        losses.append(float(m1["loss"]))
        norms.append(float(m1["grad_norm"]))
        for i in range(1, FAM_FLOAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch(i))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {k: v for k, v in build.counts().items() if v}
    if counts:
        fail(f"{label}: the float steps launched kernels {counts} (the float step has none)")
    if not all(np.isfinite(losses + norms)):
        fail(f"{label}: non-finite losses {losses} or grad norms {norms}")
    del opt, m1
    gc.collect()
    torch.cuda.empty_cache()

    fapi = zoo.build(cfg, dataclasses.replace(rt, quant_mode="fake"), device="cuda")
    params["codebooks"] = default_universal_codebooks().as_tensor("cuda")
    opt = adamw.init_state(params)
    fstep = train.make_train_step(fapi, opt_cfg)
    sites = fam_fake_sites(cfg)
    torch.cuda.synchronize()
    build.reset_counts()
    with train.deterministic():
        t0 = time.perf_counter()
        out = fstep(params, opt, batch(FAM_FLOAT_STEPS))
        torch.cuda.synchronize()
        fake_ms = 1e3 * (time.perf_counter() - t0)
    fcounts = {k: v for k, v in build.counts().items() if v}
    if fcounts != {"bcq_quantize": sites}:
        fail(f"{label}: the fake step launched {fcounts}, expected B3 {sites} times "
             "(fam_fake_sites; the universal books take the table)")
    fake_loss = float(out[2]["loss"])
    if not np.isfinite(fake_loss) or not np.isfinite(float(out[2]["grad_norm"])):
        fail(f"{label}: the fake step's loss {fake_loss} or grad_norm is not finite")
    del out, opt
    gc.collect()
    same, leaves, ties, held_n, cb_diff = fake_grads_equal(params, batch(FAM_FLOAT_STEPS), fapi,
                                                           label)
    if held_n != sites:
        fail(f"{label}: the held gradient step launched B3 {held_n} times, expected {sites}")
    tokens = batch_rows * seq
    step_ms = float(np.mean(ms))
    res = {"arch": arch, "layers": cfg.n_layers, "params": n_params, "tokens_a_step": tokens,
           "init_s": init_s, "first_step_ms": first_ms, "ms_per_step": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak_gb, "losses": losses,
           "grad_norms": norms, "fake_step_ms": fake_ms, "fake_loss": fake_loss,
           "b3_launches": sites, "fake_gradient_leaves_equal": f"{same}/{leaves}",
           "fake_ties": ties, "codebook_gradient_max_diff": cb_diff}
    del params, fapi, api
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_fam
    print(f"{label}: {cfg.n_layers} layers at full width ({n_params / 1e9:.3f} B params, drawn "
          f"in {init_s:.1f} s), {batch_rows} × {seq} tokens a step, bf16 compute on f32 params: "
          f"step 1 {first_ms:.1f} ms (run twice: bit-equal), steps 2–{FAM_FLOAT_STEPS} "
          f"{step_ms:.1f} ms/step ({res['tokens_per_s']:.0f} tokens/s), peak {peak_gb:.1f} GB, "
          f"losses {[round(x, 4) for x in losses]}, grad norms {[round(x, 4) for x in norms]}, no "
          f"kernel launched; --quant fake step {fake_ms:.1f} ms, loss {fake_loss:.4f}, B3 "
          f"{sites} launches, its loss and {same} of {leaves} gradient leaves equal to the plain "
          f"route's ({held_n} launches held, {ties} ties, codebook gradient Δ {cb_diff:.3e}); "
          f"{res['seconds']:.1f} s; {smi}", flush=True)
    return res


def phase_families_train(smi):
    """Phase 26: training of the MoE, SSM, hybrid and enc-dec families at
    full width (``fam_train``), one family at a time, the cache freed
    between them.  Returns (B3's launches of the fake steps — the main
    path's run —, the families' numbers)."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # RecurrentGemma's period peaks at ~73 GB allocated (f32 params, grads,
    # two moments and the out-of-place update's new three: ~28 B a
    # parameter); the caching allocator's fixed segments then reserve past
    # the card's 79 GiB (81.3 GB reserved on an H100), expandable ones do
    # not (73.5 GB).  The last phase, so the setting stays with it.
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        rows = [fam_train(*spec, smi) for spec in FAM_TRAIN]
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    print("phase 26 summary: " + "; ".join(
        f"{r['arch']} {r['ms_per_step']:.1f} ms/step, {r['tokens_per_s']:.0f} tokens/s, peak "
        f"{r['peak_gb']:.1f} GB" for r in rows)
        + f"; phase 26 {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return sum(r["b3_launches"] for r in rows), rows


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
    can take) is profiled again, up to ``tries`` times.  Where no window
    did, the profiler has lost the card (it once saw no event in any of
    them): the whole call is then timed between CUDA events over ``iters``
    calls, under the one name ``EVENTS_TIMER``."""
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
    print(f"  ({what}: torch.profiler lost its kernels in {tries} windows of {iters} calls "
          f"(last window's events by kernel: {seen}); timed between CUDA events)", flush=True)
    return {EVENTS_TIMER: cuda_ms(fn, iters=iters, warmup=1)}


def device_ms(by_name):
    """Device ms per call summed over a call's kernels.  Where a call's
    device work is a few microseconds, back-to-back calls are paced by the
    host, and ``cuda_ms`` measures that pace instead."""
    return sum(by_name.values())


def _linear_split(by_name):
    """B1's two device kernels: encode pass and GEMM, ms per call."""
    pick = lambda key: sum(ms for nm, ms in by_name.items() if key in nm) or None  # noqa: E731
    return {"encode_ms": pick("encode_kernel"), "gemm_ms": pick("gemm_"),
            "device_ms": device_ms(by_name), "timer": timer(by_name)}


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
          f"{fmt(split['encode_ms'])}, GEMM {fmt(split['gemm_ms'])}, {split['timer']}), plain "
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


def _gather_times(cb, c, kv_len, seed, h=12, hkv=12, d=64, cfg=None, profile=True):
    """Page gather (bcq4 in the format ``cfg``, default ``BCQConfig()``,
    page 16, ``h`` query heads of ``d`` over ``hkv`` KV heads; gpt3_126m's
    12 of 64 by default) over rows of ``kv_len`` tokens with ``c`` queries
    each: kernel (event loop and, with ``profile``, device time of its two
    launches), plain, bound (``common.gather_cost``'s bytes)."""
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.kernels import common

    cfg = cfg or BCQConfig()
    ps = 16
    b = len(kv_len)
    maxp = -(-max(kv_len) // ps)
    n_pages = 1 + b * maxp
    pool = gather_pool("bcq4", n_pages, ps, hkv, d, seed, cb, cfg)
    bt, kvl = gather_case(b, maxp, ps, kv_len, seed + 1, n_pages)
    q = torch.randn((b, c, h, d), generator=torch.Generator().manual_seed(seed + 2)).cuda()
    run = (q, pool, bt, kvl, "bcq4", cfg, cb)
    ms = cuda_ms(lambda: common.page_gather_attention(*run))
    plain_ms = cuda_ms(lambda: common.page_gather_attention_plain(*run), iters=10)
    ok, err = held(common.page_gather_attention(*run), common.page_gather_attention_plain(*run),
                   GATHER_TOL, GATHER_TOL)
    if not ok:
        fail(f"page_gather disagrees with its plain version at C={c} kv_len={kv_len}: {err:.3e}")
    nbytes, work = common.gather_cost("bcq4", q, common.page_pool_leaves(pool, "bcq4")[0], bt,
                                      kv_len, cfg)
    flops = work["f32"]  # QK and PV of every query head over its causally visible keys
    bound, by = _bound(nbytes, (flops, F32_FLOPS))
    if not profile:
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "err": err}
    by_name = kernel_split_ms(lambda: common.page_gather_attention(*run), bound,
                              f"page_gather at C={c}")
    pick = lambda key: sum(t for nm, t in by_name.items() if key in nm) or None  # noqa: E731
    return {"ms": ms, "device_ms": device_ms(by_name), "split_ms": pick("split_kernel"),
            "combine_ms": pick("combine_kernel"), "timer": timer(by_name), "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by, "nbytes": nbytes, "flops": flops, "err": err}


def time_gather(cb, worst_err, launches):
    kv_dec = [n + GEN for n in PROMPT_LENS]  # decode at the end of the serving run
    dec = _gather_times(cb, 1, kv_dec, 5)
    kv_pre = [500] * 8  # a full prefill chunk of 8 rows at the longest prompt
    pre = _gather_times(cb, 64, kv_pre, 15)
    for nm, t, shape in (("decode", dec, f"B=8 C=1 kv_len={kv_dec}"),
                         ("chunked prefill", pre, "B=8 C=64 kv_len=500")):
        fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
        dev = (f"{t['device_ms']:.4f} ms = split {fmt(t['split_ms'])} + combine "
               f"{fmt(t['combine_ms'])}")
        print(f"page_gather timing at {nm} {shape} H=12 D=64 bcq4: kernel {t['ms']:.4f} ms "
              f"(device {dev}, {t['timer']}), plain {t['plain_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({t['nbytes']} B, "
              f"{t['flops']} f32 FLOP); kernel vs plain max|err| {t['err']:.3e}"
              + (f"; earlier run: {EARLIER_MS['page_gather']} ms" if nm == "decode" else ""), flush=True)
    strip = lambda t: {k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "timer")}  # noqa: E731
    return {
        "name": "page_gather", "route": "cuda", "source": "src/repro_torch/csrc/page_gather.cu",
        "replaces": "src/repro/kernels/common.py:265", "launches": sum(launches.values()),
        "launches_by_path": launches, "max_abs_err": worst_err, **strip(dec), "library_ms": None,
        "bound_peak": "f32 67 TFLOP/s", "shape": "B 8 C 1 H 12 D 64 bcq4 kv 80-532 (decode)",
        "at_prefill": dict(strip(pre), shape="B 8 C 64 H 12 D 64 bcq4 kv 500"),
    }


def _flash_times(bh, s_len, d, heads):
    """Flash, bf16 and causal, at (bh, s_len, d): kernel, plain and SDPA
    (on (bh / heads, heads, s_len, d)) ms, the bound, kernel vs plain
    max|err|, and the inputs."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    q, k, v = (torch.randn((bh, s_len, d), device="cuda").to(torch.bfloat16) for _ in range(3))
    ms = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v, True), iters=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True), iters=5)
    tol = FLASH_TOL["bfloat16"]
    ok, err = held(fa.flash_attention_kernel(q, k, v, True), fa.flash_attention_plain(q, k, v, True),
                   tol, tol)
    if not ok:
        fail(f"flash disagrees with its plain version at BH={bh} S={s_len} D={d}: {err:.3e}")
    q4, k4, v4 = (t.reshape(bh // heads, heads, s_len, d) for t in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), iters=20)
    nbytes = 4 * bh * s_len * d * 2  # q, k, v read once, out written once
    pairs = s_len * (s_len + 1) // 2  # causal (query, key) pairs per head
    flops = 4 * d * pairs * bh  # q·k and p·v
    bound, by = _bound(nbytes, (flops, BF16_FLOPS))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
            "bound_by": by, "err": err, "nbytes": nbytes, "flops": flops, "inputs": (q, k, v)}


def time_flash(worst_err, launches):
    """Flash at the evaluation shape: (4 · 12, 2048, 64) bf16, causal."""
    from repro_torch.kernels import flash_attention as fa

    bh, s_len, d = EVAL_BATCH * 12, EVAL_SEQ, 64
    t = _flash_times(bh, s_len, d, 12)
    q32, k32, v32 = (x.float() for x in t.pop("inputs"))  # the f32 specialisation (CUDA cores)
    f32_ms = cuda_ms(lambda: fa.flash_attention_kernel(q32, k32, v32, True), iters=5)
    ok32, err32 = held(fa.flash_attention_kernel(q32, k32, v32, True),
                       fa.flash_attention_plain(q32, k32, v32, True), *(FLASH_TOL["float32"],) * 2)
    if not ok32:
        fail(f"f32 flash disagrees with its plain version at BH={bh} S={s_len} D={d}: {err32:.3e}")
    print(f"flash timing at BH={bh} S={s_len} D={d} bf16 causal: kernel {t['ms']:.4f} ms (earlier "
          f"run: {EARLIER_MS['flash_attention']} ms), plain {t['plain_ms']:.4f} ms, SDPA "
          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by {t['bound_by']} "
          f"({t['nbytes']} B, {t['flops']} FLOP at the bf16 tensor-core peak; "
          f"{t['flops'] / F32_FLOPS * 1e3:.4f} ms at the f32 peak); kernel vs plain max|err| "
          f"{t['err']:.3e}; f32 specialisation on f32 inputs {f32_ms:.4f} ms (max|err| "
          f"{err32:.3e})", flush=True)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26", "launches": launches,
        "max_abs_err": worst_err, **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms")},
        "bound_peak": "bf16 989 TFLOP/s", "shape": f"BH {bh} S {s_len} D {d} bf16 causal",
        "f32_ms": f32_ms,
    }


def _write_times(cb, c, seed, h=12, d=64, cfg=None, profile=True):
    """The KV-page writer at a serving shape: 8 rows of ``c`` tokens (c ==
    1: a decode tick; c == 64: a prefill chunk, every slot of 4 pages a
    row) of ``h`` KV heads of ``d`` (gpt3_126m's 12 of 64 by default), f32
    K and V (the serving run's compute dtype), into a pool of the serving
    run's size.  Kernel (event loop, device time), plain writer, bound; the
    two pools must end byte-equal.  ``cfg``: the pages' format (default
    ``BCQConfig()``); ``profile`` False skips the profiled device time."""
    import torch

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.kernels.bcq_quantize import page_write_cost
    from repro_torch.models import layers

    cfg = cfg or BCQConfig()
    b, ps, n_pages = 8, 16, 1 + 8 * 34
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
    diff = _pool_diff(pool, plain, cb, cfg)
    if diff != 0:
        fail(f"the KV-page writer disagrees with the plain writer at C={c} {cfg.tag()} ({diff})")
    la = cfg.array_len if d % cfg.array_len == 0 else min(cfg.array_len, d)
    nbytes, work = page_write_cost(k, rows, la, sum(t.numel() * t.element_size() for t in ids),
                                   cfg)
    ops = work["f32"]
    bound, by = _bound(nbytes, (ops, F32_FLOPS))
    if not profile:
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
    by_name = kernel_split_ms(run, bound, f"the KV-page writer at C={c}")
    return {"ms": ms, "device_ms": device_ms(by_name), "timer": timer(by_name),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "nbytes": nbytes, "ops": ops}


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
    by_name = kernel_split_ms(lambda: bq.bcq_quantize(x, cb, s_x, cfg), bound,
                              f"bcq_quantize at M={m} K={k}")
    dev = device_ms(by_name)
    fmt = lambda v: f"{v:.4f} ms"  # noqa: E731
    print(f"quantize timing at M={m} K={k} (banked-table encode of bcq_encode.cuh): kernel "
          f"{ms:.4f} ms (device {fmt(dev)}, {timer(by_name)}), plain {plain_ms:.4f} ms, bound "
          f"{bound:.5f} ms by {by} ({nbytes} B, {ops} f32 operations); earlier run: device "
          f"{EARLIER_MS['bcq_quantize']} ms", flush=True)
    writes = {}
    for nm, c, seed in (("decode", 1, 61), ("prefill", 64, 62)):
        t = writes[nm] = _write_times(cb, c, seed)
        print(f"KV-page writer timing at {nm} (8 rows × {c} token{'s' if c > 1 else ''} × 12 "
              f"heads × 64, K and V f32, bcq4 pages of 16): kernel {t['ms']:.4f} ms (device "
              f"{fmt(t['device_ms'])}, {t['timer']}), plain writer {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['nbytes']} B, {t['ops']} f32 "
              f"operations); page bytes equal to the plain writer's", flush=True)
    strip = lambda t: {n: t[n] for n in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "timer")}  # noqa: E731
    return {
        "name": "bcq_quantize", "route": "cuda", "source": "src/repro_torch/csrc/bcq_quantize.cu",
        "replaces": "src/repro/kernels/bcq_quantize.py:31", "launches": sum(launches.values()),
        "launches_by_path": launches, "max_abs_err": worst_err, "ms": ms, "device_ms": dev,
        "timer": timer(by_name), "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "bound_peak": "f32 67 TFLOP/s", "shape": f"M {m} K {k}",
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
    by_name = kernel_split_ms(lambda: bm.bcq_matmul(*args), bound,
                              f"bcq_matmul at M={m} K={k} N={n}")
    dev = device_ms(by_name)
    print(f"matmul timing at M={m} K={k} N={n}: kernel {ms:.4f} ms (device "
          f"{dev:.4f} ms, {timer(by_name)}), plain {plain_ms:.4f} ms, "
          f"torch.matmul bf16 {library_ms:.4f} ms, bound {bound:.5f} ms by {by} ({nbytes} B, "
          f"{2 * m * n * k} OP at the int8 tensor-core peak; {2 * m * n * k / F32_FLOPS * 1e3:.5f} ms "
          f"at the f32 peak); earlier run: {EARLIER_MS['bcq_matmul']} ms", flush=True)
    return {
        "name": "bcq_matmul", "route": "cuda", "source": "src/repro_torch/csrc/bcq_matmul.cu",
        "replaces": "src/repro/kernels/bcq_matmul.py:52", "launches": launches,
        "max_abs_err": worst_err, "ms": ms, "device_ms": dev, "timer": timer(by_name),
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
        "bound_peak": "int8 tensor cores 1979 TOP/s", "shape": f"M {m} K {k} N {n}",
    }


def check_bounds(kernels):
    """No time in the ``kernels`` line may read below its bound: the card
    cannot do the work faster, so such a reading is a measurement fault."""
    for entry in kernels:
        timings = entry.get("formats", {}).get("timings", [])
        for at in ([entry] + [v for v in entry.values() if isinstance(v, dict) and "bound_ms" in v]
                   + timings):
            for key in ("ms", "device_ms"):
                if at.get(key) is not None and at[key] < at["bound_ms"]:
                    fail(f"{entry['name']} ({at.get('shape')}): {key} {at[key]:.5f} reads below "
                         f"its bound {at['bound_ms']:.5f} ms")


def main() -> int:
    # before the first cuBLAS call: phase 21's training runs in this process
    # and in its subprocess take the deterministic algorithms with one
    # cuBLAS workspace setting (launch.train sets the same in its own main)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    t_start = t0 = time.perf_counter()
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
    counts_train, train_ck, trained_form = phase_train(smi)
    counts_ptq, err_ptq, fake_form, ptq_losses = phase_ptq(cb, smi, train_ck)
    counts_state, state_entry, err_state = phase_state(cb, smi)
    counts_hyb, hyb_entry, err_hyb = phase_hybrid(cb, smi)
    counts_enc, flash_enc, enc_entry, flash_entry, err_enc = phase_encdec(cb, smi)
    counts_zoo, vlm_b1, (lin_zoo, gat_zoo, wri_zoo), err_zoo = phase_zoo(cb, smi)
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
    kernels[3]["launches_by_path"]["training"] = counts_train
    kernels[3]["launches"] = sum(kernels[3]["launches_by_path"].values())
    kernels[3]["trained_books"] = trained_form
    kernels[3]["probe_form"] = probe_form
    kernels[3]["fake_quant_form"] = fake_form
    kernels[0]["launches_by_path"]["state"] = counts_state
    kernels[0]["launches_by_path"]["hybrid"] = counts_hyb
    kernels[0]["launches_by_path"]["encdec"] = counts_enc
    kernels[0]["launches"] = sum(kernels[0]["launches_by_path"].values())
    kernels[0].update(state_entry)
    kernels[0].update(hyb_entry)
    kernels[0].update(enc_entry)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], err_slab, err_moe["bcq_linear"],
                                    err_ptq["bcq_linear"], err_state, err_hyb,
                                    err_enc["bcq_linear"])
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], err_moe["page_gather"],
                                    err_ptq["page_gather"])
    kernels[2]["launches_by_path"]["encdec_eval"] = flash_enc
    kernels[2]["launches"] = sum(kernels[2]["launches_by_path"].values())
    kernels[2].update(flash_entry)
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], err_ptq["flash_attention"],
                                    err_enc["flash_attention"])
    kernels[0]["launches_by_path"]["dense_zoo"] = counts_zoo["bcq_linear"]
    kernels[0]["launches_by_path"]["vlm"] = vlm_b1
    kernels[1]["launches_by_path"]["dense_zoo"] = counts_zoo["page_gather"]
    kernels[3]["launches_by_path"]["dense_zoo"] = counts_zoo["bcq_page_write"]
    for i, at, name in ((0, lin_zoo, "bcq_linear"), (1, gat_zoo, "page_gather"),
                        (3, wri_zoo, "bcq_page_write")):
        kernels[i].update(at)
        kernels[i]["launches"] = sum(kernels[i]["launches_by_path"].values())
        kernels[i]["max_abs_err"] = max(kernels[i]["max_abs_err"], err_zoo[name])
    counts_mesh, mesh_entry = phase_mesh(cb, smi, trained_form["train_ms_per_step"])
    kernels[3]["launches_by_path"]["mesh"] = counts_mesh
    kernels[3]["launches"] = sum(kernels[3]["launches_by_path"].values())
    kernels[3]["mesh"] = mesh_entry
    print(f"chip_smoke: phases 1–23 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    counts_fmt, fmt_entries = phase_formats(smi, train_ck, ptq_losses)
    phase_examples(smi)
    counts_fam, fam_rows = phase_families_train(smi)
    for entry, name, counters in ((kernels[0], "bcq_linear", ("bcq_linear",)),
                                  (kernels[1], "page_gather", ("page_gather",)),
                                  (kernels[3], "bcq_quantize", ("bcq_quantize", "bcq_page_write")),
                                  (kernels[4], "bcq_matmul", ()),
                                  (stacked, "bcq_linear_experts", ())):
        entry["formats"] = fmt_entries[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], fmt_entries[name].get("max_abs_err", 0.0))
        if counters:
            entry["launches_by_path"]["formats"] = sum(counts_fmt.get(c, 0) for c in counters)
            entry["launches"] = sum(entry["launches_by_path"].values())
    kernels[3]["launches_by_path"]["family_training"] = counts_fam
    kernels[3]["launches"] = sum(kernels[3]["launches_by_path"].values())
    kernels[3]["family_training"] = fam_rows
    kernels.insert(1, stacked)
    check_bounds(kernels)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
