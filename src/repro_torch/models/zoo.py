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
reference."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bcq import check_kernel_config
from repro_torch.core.calibrate import default_universal_codebooks
from repro_torch.core.ptq import decode_scales, pack_params, quantize_params
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.layers import Runtime

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
