"""ArchConfig → model API (counterpart of the dense and MoE branch of
``repro/models/zoo.build``): random init, the loss of a batch (the
evaluation forward), the paged decode step, the page-pool init, the
chunked-prefill step, and the slab ``prefill`` / contiguous
``decode_step`` pair, all on one device."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.calibrate import default_universal_codebooks
from repro_torch.core.ptq import decode_scales, pack_params
from repro_torch.models import transformer
from repro_torch.models.layers import Runtime


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
    paged_decode_fn: Callable[..., Any]
    pool_init: Callable[..., Any]
    prefill_from_pages_fn: Callable[..., Any]
    prefill_fn: Callable[..., Any]
    decode_fn: Callable[..., Any]
    # captures of the serving step functions over every engine on this
    # api (``PagedEngine.trace_counts``): the decode step's CUDA graphs;
    # the prefills run eagerly and capture nothing
    trace_counts: dict = dataclasses.field(
        default_factory=lambda: {"prefill": 0, "decode": 0, "chunk": 0})


SERVED_FAMILIES = ("dense", "moe")
TO_PORT_FAMILIES = ("ssm", "hybrid", "encdec", "vlm")


def build(cfg: ArchConfig, rt: Runtime, device="cuda") -> ModelAPI:
    """The model API of a dense or MoE decoder.  ``init(seed)`` draws
    random weights from seeded ``torch.Generator``s; with
    ``quant_mode="packed"`` they are packed to W4 with the frozen
    universal codebooks, which ride in ``params["codebooks"]``, and their
    dequant scales decoded once (``ptq.decode_scales``).  A dense model is
    drawn whole on the CPU, then moved to ``device``.  A MoE model is drawn
    on ``device`` layer by layer, each layer from its own generator seeded
    from (seed, layer) and packed before the next is drawn, so at most one
    layer's float experts are ever resident (full-width Moonlight's float
    experts alone would be ~106 GB)."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"the port serves the {' and '.join(SERVED_FAMILIES)} families, not "
            f"{cfg.family!r}; still to be ported: {', '.join(TO_PORT_FAMILIES)}")
    device = resolve_device(device)

    def codebooks():
        if rt.quant_mode != "none" or rt.cache_kind == "bcq4":
            return default_universal_codebooks(rt.bcq_cfg).as_tensor(device)
        return None

    def init(seed: int = 0) -> dict:
        if cfg.family == "moe":
            return _init_by_layer(cfg, rt, device, seed, codebooks())
        params = transformer.init_lm(cfg, rt, torch.Generator().manual_seed(seed))
        params = _to(params, device)
        cb = codebooks()
        if cb is not None:
            if rt.quant_mode == "packed":
                params = decode_scales(pack_params(params, cb, rt.bcq_cfg))
            params["codebooks"] = cb
        return params

    return ModelAPI(
        cfg, rt, device,
        init=init,
        loss_fn=lambda p, b: transformer.forward_train(p, b, cfg, rt),
        paged_decode_fn=lambda p, pool, t, bt, ln: transformer.paged_decode_step(
            p, pool, t, bt, ln, cfg, rt
        ),
        pool_init=lambda n_pages, ps: transformer.cache_init_stacked(
            cfg, rt, n_pages, ps, device=device
        ),
        prefill_from_pages_fn=lambda p, t, pool, bt, n_past, ids, chunk_len=None: (
            transformer.prefill_from_pages(p, t, pool, bt, n_past, ids, cfg, rt, chunk_len)
        ),
        prefill_fn=lambda p, b, ml: transformer.prefill(p, b, cfg, rt, ml),
        decode_fn=lambda p, c, t, pos: transformer.decode_step(p, c, t, pos, cfg, rt),
    )


def _generator(device, seed: int, layer: int) -> torch.Generator:
    """The generator of one layer (``layer`` ≥ 0) or of the parameters
    outside the stack (``layer`` -1), seeded from (seed, layer)."""
    return torch.Generator(device=device).manual_seed(seed * 65536 + layer + 1)


def _init_by_layer(cfg, rt: Runtime, device, seed: int, cb) -> dict:
    """A MoE model drawn and packed one layer at a time into preallocated
    (L, ...) leaves."""
    params = transformer.init_top(cfg, rt, _generator(device, seed, -1))
    stack = None
    for i in range(cfg.n_layers):
        block = transformer.init_block(cfg, rt, _generator(device, seed, i))
        if rt.quant_mode == "packed":
            block = decode_scales(pack_params(block, cb, rt.bcq_cfg))
        if stack is None:
            stack = _alloc_stack(block, cfg.n_layers)
        _put_layer(stack, block, i)
        del block
    params["layers"] = stack
    if cb is not None:
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
