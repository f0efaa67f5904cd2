"""ArchConfig → model API (counterpart of the dense branch of
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


def build(cfg: ArchConfig, rt: Runtime, device="cuda") -> ModelAPI:
    """The model API of a dense decoder.  ``init(seed)`` draws random
    weights from a seeded ``torch.Generator`` (on the CPU, then moved to
    ``device``); with ``quant_mode="packed"`` they are packed to W4 with
    the frozen universal codebooks, which ride in ``params["codebooks"]``,
    and their dequant scales decoded once (``ptq.decode_scales``)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"the port serves dense decoders only, not {cfg.family!r}")
    device = resolve_device(device)

    def init(seed: int = 0) -> dict:
        params = transformer.init_lm(cfg, rt, torch.Generator().manual_seed(seed))
        params = _to(params, device)
        if rt.quant_mode != "none" or rt.cache_kind == "bcq4":
            cb = default_universal_codebooks(rt.bcq_cfg).as_tensor(device)
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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
