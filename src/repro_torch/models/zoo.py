"""ArchConfig → model API (counterpart of ``repro/models/zoo.build``, every
family: dense, MoE, VLM, SSM, hybrid, enc-dec): random init, the loss of
a batch (the evaluation forward), the slab ``prefill`` / contiguous
``decode_step`` pair and what the paged engines need, all on one device.
``page_spec`` says what the page pool holds: a dense or MoE model serves
KV pages (the paged decode step, the page-pool init, the chunked-prefill
step) through ``serving.engine.PagedEngine``; an SSM, a hybrid or an
enc-dec model serves ``state`` pages (the live cache tree and its per-row
decode) through ``serving.state_engine.StatePagedEngine``, an enc-dec
model with its encoder output in ``shared_ro`` pages besides.  A VLM
keeps the transformer's KV machinery but has no page spec: its prefill
needs patch embeddings that paged admission does not carry, so it serves
contiguously only (``launch.batching``, ``serving.generate``), as in the
reference.

The sharding rules (the reference's, spec for spec) and the dry-run's
stand-ins: ``param_pspecs``, ``cache_pspecs`` and ``batch_pspecs`` lay a
tree out over a mesh's named axes (per-pod mesh ('data', 'model'); the
multi-pod mesh adds a leading 'pod' axis, data-parallel by default):

* GEMM kernels (K, N): FSDP over 'data' on K, TP over 'model' on N — each
  applied only when the dim divides the axis (else replicated on that dim);
* embeddings / lm_head: vocab over 'model', d_model over 'data';
* MoE expert kernels (E, K, N): EP over 'model' on E, FSDP over 'data' on K
  (``MOE_EXPERT_SPEC``; ``PARAM_LAYOUT`` 'tp' keeps weights whole over
  'data', the serving layout);
* stacked layers get a leading None (the layer axis is not sharded);
* KV caches: batch over 'data'; kv-heads over 'model' when divisible,
  else the *sequence* dim takes 'model' (e.g. full-MHA 40-head caches);
* norms / biases / codebooks: replicated.

A spec is the reference's ``PartitionSpec`` as a tuple (``launch/mesh.py``).
``param_shapes``, ``input_specs`` and ``cache_specs`` give the trees on the
meta device, drawing and allocating nothing."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.bcq import check_kernel_config
from repro_torch.core.calibrate import default_universal_codebooks
from repro_torch.core.ptq import decode_scales, pack_params, quantize_params
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.layers import Runtime

STACK_TOKENS = ("layers", "periods", "enc_layers", "dec_layers")

# MoE expert-kernel sharding policy: 'fsdp' (default — EP×FSDP, weights
# gathered over 'data' per use) or 'tp2d' (EP×TP — activations reduced
# instead).
MOE_EXPERT_SPEC = "fsdp"

# Param layout: 'fsdp' (training default — ZeRO-3 over 'data' + TP over
# 'model') or 'tp' (serving — TP-only, params replicated over 'data' so no
# per-step weight all-gathers).
PARAM_LAYOUT = "fsdp"

# the families the paged engines serve (either engine); ``vlm`` is built
# and served contiguously only, as in the reference
SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


class UnsupportedModelError(RuntimeError):
    """A model family without a paged-serving path was asked to serve
    paged (or asked the wrong engine): names the family and the servable
    list, so the caller can pick a servable config or engine."""

    def __init__(self, name: str, family: str, reason: str = ""):
        self.family = family
        self.supported = SERVED_FAMILIES
        msg = (f"model '{name}' (family '{family}') has no paged-serving path; "
               f"paged-servable families: {', '.join(SERVED_FAMILIES)}.")
        if reason:
            msg += f" {reason}"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """What a family's page pool holds — what the engines, the audit and
    the telemetry read instead of assuming pages are KV.

    layout: ``kv_paged`` (block-table KV pages: token position → (page,
    slot); copy-on-write forks; prefix caching) or ``state_checkpoint``
    (one ``state`` page checkpoints a sequence's whole O(1) recurrent state
    at page-aligned positions; preemption replays at most page_size
    tokens).  shared_encoder: the encoder output in read-only ``shared_ro``
    pages keyed by the input's hash (enc-dec)."""

    layout: str
    shared_encoder: bool = False


def page_spec(cfg: ArchConfig):
    """What a served family's page pool holds: ``state`` pages for the
    O(1)-state families (ssm, hybrid) and for enc-dec (its decoder self
    caches; the encoder output in ``shared_ro`` pages), KV pages for the
    dense and MoE families; None for a VLM, which keeps the KV machinery
    but is not paged-servable (its prefill needs patch embeddings the
    engines cannot supply)."""
    if cfg.family == "vlm":
        return None
    if cfg.family == "encdec":
        return PageSpec("state_checkpoint", shared_encoder=True)
    return PageSpec("state_checkpoint" if cfg.family in ("ssm", "hybrid") else "kv_paged")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    raises (pass ``device="cpu"`` to run the plain versions on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port's "
            "plain PyTorch versions on the CPU"
        )
    return device


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    rt: Runtime
    device: torch.device
    init: Callable[[int], Any]
    loss_fn: Callable[..., Any]
    # the reference's training tree (``init_train(seed)``): the float
    # weights, plus the universal codebooks as a float leaf in the W4A4
    # modes, whatever ``init`` serves
    init_train: Callable[[int], Any]
    prefill_fn: Callable[..., Any]
    decode_fn: Callable[..., Any]
    # the transformer families' contiguous caches, ``cache_init(B, max_len)``
    # (leaves (L, B, max_len, ...) on the api's device): what
    # ``launch.batching.ContinuousBatcher`` serves from
    cache_init: Callable[..., Any] = None
    # what the page pool holds (None: not paged-servable)
    page_spec: PageSpec = None
    # kv_paged families: the paged decode step, the page-pool init and the
    # chunked prefill against the pool
    paged_decode_fn: Callable[..., Any] = None
    pool_init: Callable[..., Any] = None
    prefill_from_pages_fn: Callable[..., Any] = None
    # state_checkpoint families: the resident live cache tree of B rows,
    # ``live_cache_init(B, max_len, device=...)`` (``device="meta"``: shapes
    # only; ``max_len`` sizes an enc-dec model's self caches, the others
    # ignore it), and the per-row decode over it, ``state_decode_fn(params,
    # live, tokens (B, 1), pos (B,), shared=None)`` → (logits (B, 1, V),
    # live), in place; ``shared`` = (encoder pool, (B,) page ids) for enc-dec
    live_cache_init: Callable[..., Any] = None
    state_decode_fn: Callable[..., Any] = None
    # shared_encoder families: the encode of frames (B, T, D) to the cross
    # K/V, the shared_ro page pool's init ``enc_pool_init(n_pages)``, the
    # in-place publish ``enc_store_fn(pool, xkv, pid)`` and the prefill
    # against a page's cross K/V ``prefill_with_xkv_fn(params, batch,
    # max_len, xkv)`` → (logits, self caches)
    encode_xkv_fn: Callable[..., Any] = None
    enc_pool_init: Callable[..., Any] = None
    enc_store_fn: Callable[..., Any] = None
    prefill_with_xkv_fn: Callable[..., Any] = None
    # captures of the serving step functions over every engine on this
    # api (``PagedEngine.trace_counts``): the decode step's CUDA graphs;
    # the prefills run eagerly and capture nothing
    trace_counts: dict = dataclasses.field(
        default_factory=lambda: {"prefill": 0, "decode": 0, "chunk": 0})



def build(cfg: ArchConfig, rt: Runtime, device="cuda") -> ModelAPI:
    """The model API of a dense, MoE or VLM-backbone decoder, a Mamba-2
    SSM, an RG-LRU hybrid or a Whisper-style encoder-decoder; another
    family raises ``ValueError``, as the reference's.
    ``init(seed)`` draws random weights from seeded ``torch.Generator``s; with
    ``quant_mode="packed"`` they are packed to W4 with the frozen
    universal codebooks, which ride in ``params["codebooks"]``, and their
    dequant scales decoded once (``ptq.decode_scales``); with ``"fake"``
    they are fake-quantized offline (``ptq.quantize_params``, the
    reference's W4A4 serving tree), with ``"fake_full"`` left float.  An
    SSM or enc-dec model is drawn whole on the CPU, then moved to
    ``device``.  A dense, VLM or MoE model is drawn on ``device`` layer
    by layer, each layer from its own generator seeded from (seed, layer)
    and packed before the next is drawn, so at most one layer's floats
    are resident in packed mode (the fake modes keep the float stack;
    full-width Qwen1.5-32B is ~130 GB in f32, Moonlight's float experts
    alone ~106 GB); a hybrid likewise period by period and tail block by
    tail block (full-width RecurrentGemma-9B is ~34 GB in f32).  The
    (L, K, N) stacks keep one s_X a layer (a period), the layout of the
    reference's packed tree."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        raise ValueError(cfg.family)
    if torch.device(device).type == "cuda" and (
            rt.quant_mode in ("fake", "fake_full") or (rt.quant_mode == "packed" and rt.fused_linear)):
        check_kernel_config(rt.bcq_cfg, f"zoo.build(quant_mode={rt.quant_mode!r})")
    device = resolve_device(device)

    def codebooks():
        if rt.quant_mode != "none" or rt.cache_kind == "bcq4":
            return default_universal_codebooks(rt.bcq_cfg).as_tensor(device)
        return None

    def init(seed: int = 0) -> dict:
        if cfg.family not in ("ssm", "encdec"):
            return _init_by_layer(cfg, rt, device, seed, codebooks())
        draw = ssm.init_ssm_lm if cfg.family == "ssm" else encdec.init_encdec
        params = draw(cfg, rt, torch.Generator().manual_seed(seed))
        params = _to(params, device)
        cb = codebooks()
        if cb is not None:
            if rt.quant_mode == "packed":
                params = decode_scales(pack_params(params, cb, rt.bcq_cfg))
            elif rt.quant_mode == "fake":
                params = quantize_params(params, cb, rt.bcq_cfg)
            params["codebooks"] = cb
        return params

    def init_train(seed: int = 0) -> dict:
        """What the reference's train CLI starts from (``train.py:108-113``):
        the float weights — this api's draw under
        ``quant_mode="none"`` — and, unless ``rt.quant_mode`` is ``none``,
        the universal codebooks as a float leaf that training updates."""
        floats = dataclasses.replace(rt, quant_mode="none", cache_kind="bf16")
        params = build(cfg, floats, device).init(seed)
        if rt.quant_mode != "none":
            params["codebooks"] = default_universal_codebooks(rt.bcq_cfg).as_tensor(device)
        return params

    if cfg.family == "ssm":
        return ModelAPI(
            cfg, rt, device,
            init=init,
            init_train=init_train,
            loss_fn=lambda p, b: ssm.forward_train(p, b, cfg, rt),
            prefill_fn=lambda p, b, ml: ssm.prefill(p, b, cfg, rt, ml),
            decode_fn=lambda p, c, t, pos: ssm.decode_step(p, c, t, pos, cfg, rt),
            page_spec=page_spec(cfg),
            live_cache_init=lambda bsz, max_len=None, device=device: ssm.ssm_cache_stacked(
                cfg, bsz, device),
            state_decode_fn=lambda p, live, t, pos, shared=None: ssm.decode_step(
                p, live, t, pos, cfg, rt),
        )
    if cfg.family == "hybrid":
        return ModelAPI(
            cfg, rt, device,
            init=init,
            init_train=init_train,
            loss_fn=lambda p, b: hybrid.forward_train(p, b, cfg, rt),
            prefill_fn=lambda p, b, ml: hybrid.prefill(p, b, cfg, rt, ml),
            decode_fn=lambda p, c, t, pos: hybrid.decode_step(p, c, t, pos, cfg, rt),
            page_spec=page_spec(cfg),
            live_cache_init=lambda bsz, max_len=None, device=device: hybrid.hybrid_cache_init(
                cfg, rt, bsz, device),
            state_decode_fn=lambda p, live, t, pos, shared=None: hybrid.decode_step(
                p, live, t, pos, cfg, rt),
        )
    if cfg.family == "encdec":
        return ModelAPI(
            cfg, rt, device,
            init=init,
            init_train=init_train,
            loss_fn=lambda p, b: encdec.forward_train(p, b, cfg, rt),
            prefill_fn=lambda p, b, ml: encdec.prefill(p, b, cfg, rt, ml),
            decode_fn=lambda p, c, t, pos: encdec.decode_step(p, c, t, pos, cfg, rt),
            page_spec=page_spec(cfg),
            # a live row holds the decoder self caches; the cross K/V is read
            # from the row's shared_ro encoder page every tick
            live_cache_init=lambda bsz, max_len, device=device: {
                "self": transformer.cache_init_stacked(cfg, rt, bsz, max_len, device=device)},
            state_decode_fn=lambda p, live, t, pos, shared: encdec.decode_step_shared(
                p, live, t, pos, shared[0], shared[1], cfg, rt),
            encode_xkv_fn=lambda p, frames: encdec.encode_xkv(p, frames, cfg, rt),
            enc_pool_init=lambda n_pages: encdec.enc_pool_init(n_pages, cfg, rt, device),
            enc_store_fn=encdec.enc_store,
            prefill_with_xkv_fn=lambda p, b, ml, xkv: encdec.prefill_with_xkv(
                p, b, cfg, rt, ml, xkv),
        )
    return ModelAPI(
        cfg, rt, device,
        init=init,
        init_train=init_train,
        loss_fn=lambda p, b: transformer.forward_train(p, b, cfg, rt),
        prefill_fn=lambda p, b, ml: transformer.prefill(p, b, cfg, rt, ml),
        decode_fn=lambda p, c, t, pos: transformer.decode_step(p, c, t, pos, cfg, rt),
        cache_init=lambda bsz, ml: transformer.cache_init_stacked(cfg, rt, bsz, ml,
                                                                  device=device),
        page_spec=page_spec(cfg),
        paged_decode_fn=lambda p, pool, t, bt, ln: transformer.paged_decode_step(
            p, pool, t, bt, ln, cfg, rt
        ),
        pool_init=lambda n_pages, ps: transformer.cache_init_stacked(
            cfg, rt, n_pages, ps, device=device
        ),
        prefill_from_pages_fn=lambda p, t, pool, bt, n_past, ids, chunk_len=None: (
            transformer.prefill_from_pages(p, t, pool, bt, n_past, ids, cfg, rt, chunk_len)
        ),
    )


def _generator(device, seed: int, layer: int) -> torch.Generator:
    """The generator of one layer, period or tail block (``layer`` ≥ 0, in
    draw order) or of the parameters outside the stacks (``layer`` -1),
    seeded from (seed, layer)."""
    return torch.Generator(device=device).manual_seed(seed * 65536 + layer + 1)


def _draw_units(cfg, rt: Runtime) -> list:
    """(params key, stack depth or None for an unstacked block, draw) of
    each unit the init draws in turn: a dense, VLM or MoE model's layers;
    a hybrid's periods, then its tail blocks."""
    if cfg.family == "hybrid":
        _, n_periods, tail = hybrid._counts(cfg)
        return ([("periods", n_periods, lambda g: hybrid.init_period(cfg, rt, g))]
                + [(f"tail{t}", None, lambda g: hybrid.init_rec_block(cfg, rt, g))
                   for t in range(tail)])
    return [("layers", cfg.n_layers, lambda g: transformer.init_block(cfg, rt, g))]


def _init_by_layer(cfg, rt: Runtime, device, seed: int, cb) -> dict:
    """A dense, VLM or MoE model drawn and packed one layer at a time, a
    hybrid one period and one tail block at a time, into preallocated (n, ...)
    leaves: unit i (in ``_draw_units`` order) from generator (seed, i)."""
    params = transformer.init_top(cfg, rt, _generator(device, seed, -1))
    i = 0
    for key, n, draw in _draw_units(cfg, rt):
        stack = None
        for j in range(1 if n is None else n):
            block = draw(_generator(device, seed, i))
            i += 1
            if rt.quant_mode == "packed":
                block = decode_scales(pack_params(block, cb, rt.bcq_cfg))
            if n is None:
                stack = block
                break
            if stack is None:
                stack = _alloc_stack(block, n)
            _put_layer(stack, block, j)
            del block
        if stack is not None:  # a hybrid of fewer layers than a period has no periods
            params[key] = stack
    if cb is not None:
        if rt.quant_mode == "fake":  # each stack as one tensor, as ptq.quantize_params
            params = quantize_params(params, cb, rt.bcq_cfg)
        params["codebooks"] = cb
    return params


def _alloc_stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _alloc_stack(v, n) for k, v in tree.items()}
    return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype, device=tree.device)


def _put_layer(stack, tree, i: int) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put_layer(stack[k], v, i)
    else:
        stack[i].copy_(tree)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ------------------------------------------------------- dry-run stand-ins
def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def param_shapes(cfg: ArchConfig, rt: Runtime) -> dict:
    """The parameter tree ``build(cfg, rt).init`` makes, on the meta
    device: shapes and dtypes only, nothing drawn (the counterpart of
    ``jax.eval_shape(api.init, key)``).  The float weights are traced
    under a fake-tensor mode; the W4A4 modes add the codebooks (and
    ``packed`` packs the GEMM kernels, still on fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    floats = dataclasses.replace(rt, quant_mode="none", cache_kind="bf16")
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = build(cfg, floats, device="cpu").init(0)
        cb = None
        if rt.quant_mode != "none" or rt.cache_kind == "bcq4":
            cb = default_universal_codebooks(rt.bcq_cfg).as_tensor("cpu")
        if cb is not None:
            if rt.quant_mode == "packed":
                params = decode_scales(pack_params(params, cb, rt.bcq_cfg))
            params["codebooks"] = cb
    return _to_meta(params)


def input_specs(cfg: ArchConfig, rt: Runtime, shape: ShapeConfig) -> dict:
    """Meta stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":  # one new token against a seq_len cache
        return {"tokens": meta(b, 1)}
    specs = {"tokens": meta(b, s)}
    if shape.kind == "train":
        specs["labels"] = meta(b, s)
    if cfg.family == "vlm":
        specs["patch_embeds"] = meta(b, cfg.n_patches, cfg.d_model, dtype=torch.bfloat16)
    if cfg.family == "encdec":
        specs["frames"] = meta(b, cfg.encoder_len, cfg.d_model, dtype=torch.bfloat16)
    return specs


def cache_specs(cfg: ArchConfig, rt: Runtime, shape: ShapeConfig):
    """The serving cache of a decode cell on the meta device."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        xkv = tuple(torch.empty((cfg.n_layers, b, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim),
                                dtype=rt.compute_dtype, device="meta") for _ in range(2))
        return {"self": transformer.cache_init_stacked(cfg, rt, b, s, device="meta"), "xkv": xkv}
    if cfg.family == "ssm":
        return ssm.ssm_cache_stacked(cfg, b, device="meta")
    if cfg.family == "hybrid":
        return hybrid.hybrid_cache_init(cfg, rt, b, device="meta")
    return transformer.cache_init_stacked(cfg, rt, b, s, device="meta")


# --------------------------------------------------------- sharding rules
def _div(n, axes, name):
    return name in axes and n % axes[name] == 0


def _kernel_spec(shape, axes):
    """(K, N) GEMM kernel → FSDP('data') × TP('model')."""
    k, n = shape[-2], shape[-1]
    return (
        "data" if _div(k, axes, "data") else None,
        "model" if _div(n, axes, "model") else None,
    )


def _spec_for(path: str, shape, axes) -> tuple:
    ndim = len(shape)
    stacked = any(t in path for t in STACK_TOKENS)
    lead = (None,) if stacked else ()
    core = shape[1:] if stacked else shape

    def wrap(*dims):
        return lead + tuple(dims)

    if "codebooks" in path or ndim == 0:
        return ()
    if "embed" in path or "lm_head" in path:
        v, d = (core[0], core[1]) if core[0] > core[1] else (core[1], core[0])
        big = "model" if _div(v, axes, "model") else None
        small = None if PARAM_LAYOUT == "tp" else ("data" if _div(d, axes, "data") else None)
        if core[0] >= core[1]:
            return wrap(big, small)
        return wrap(small, big)
    if "kernel_packed" in path and len(core) >= 2:
        # packed buffers: (..., N, K') — TP on N (+ FSDP on K' for training)
        dims = [None] * len(core)
        if _div(core[-2], axes, "model"):
            dims[-2] = "model"
        if PARAM_LAYOUT != "tp" and _div(core[-1], axes, "data"):
            dims[-1] = "data"
        if len(core) == 3 and _div(core[0], axes, "model"):
            dims[0] = "model"
            dims[-2] = None
        return wrap(*dims)
    if path.endswith("kernel") and "conv" not in path:
        if PARAM_LAYOUT == "tp" and len(core) == 2 and "router" not in path:
            return wrap(None, "model" if _div(core[1], axes, "model") else None)
        if len(core) == 3:  # MoE experts (E, K, N)
            if PARAM_LAYOUT == "tp" and MOE_EXPERT_SPEC != "tp2d":
                return wrap("model" if _div(core[0], axes, "model") else None, None, None)
            if MOE_EXPERT_SPEC == "tp2d":
                # 2-D tensor parallel: EP over 'model' + TP over 'data' on
                # the non-reduction dim — no FSDP weight gathers
                if "/wo" in path:
                    return wrap("model", "data" if _div(core[1], axes, "data") else None, None)
                return wrap("model", None, "data" if _div(core[2], axes, "data") else None)
            return wrap(
                "model" if _div(core[0], axes, "model") else None,
                "data" if _div(core[1], axes, "data") else None,
                None,
            )
        if len(core) == 2:
            if "router" in path:
                return wrap(None, None)
            return wrap(*_kernel_spec(core, axes))
    return wrap(*([None] * len(core)))


def _walk(tree, leaf_fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf_fn, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, leaf_fn, f"{prefix}/{i}") for i, v in enumerate(tree))
    return leaf_fn(prefix, tree)


def param_pspecs(shape_tree, axes: dict) -> Any:
    """The spec tree of a parameter tree (any leaves with ``.shape``)."""
    return _walk(shape_tree, lambda path, leaf: _spec_for(path, tuple(leaf.shape), axes))


def _batch_dim_spec(n, axes):
    """Shard a batch-like dim over ('pod','data') jointly when possible."""
    if "pod" in axes and n % (axes["pod"] * axes["data"]) == 0:
        return ("pod", "data")
    if _div(n, axes, "data"):
        return "data"
    return None


def _cache_leaf_spec(path: str, shape, axes, stacked_lead=True) -> tuple:
    ndim = len(shape)
    if ndim <= 1:
        return ()
    lead = (None,) if stacked_lead else ()
    core = shape[1:] if stacked_lead else shape
    dims = [None] * len(core)
    # core: (B, S, H, D) / (B, S, H) / (B, S) / ssm (B, H, P, N) / (B, W)
    if len(core) >= 1:
        dims[0] = _batch_dim_spec(core[0], axes)
    if len(core) >= 3 and ("idx" in path or "sel" in path or path.endswith("k")
                           or path.endswith("v") or "scale" in path or "state" in path.lower()):
        # prefer head/model sharding on dim 2 when divisible
        if _div(core[2], axes, "model"):
            dims[2] = "model"
        elif _div(core[1], axes, "model"):
            dims[1] = "model"  # fall back: shard sequence over 'model'
    return lead + tuple(dims)


def cache_pspecs(cache_shape_tree, axes: dict) -> Any:
    return _walk(cache_shape_tree,
                 lambda path, leaf: _cache_leaf_spec(path, tuple(leaf.shape), axes))


def batch_pspecs(specs: dict, axes: dict) -> dict:
    out = {}
    for k, v in specs.items():
        dims = [None] * len(v.shape)
        if len(v.shape) >= 1:
            dims[0] = _batch_dim_spec(v.shape[0], axes)
        out[k] = tuple(dims)
    return out
