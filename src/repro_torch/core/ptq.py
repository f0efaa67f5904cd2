"""Offline packing of a parameter tree to W4 (counterpart of ``repro/core/ptq.py``).

``pack_params`` replaces every GEMM ``kernel`` leaf (d_in, d_out) — or a
stack of them, (L, d_in, d_out) per layer or (L, E, d_in, d_out) per
layer and expert, each matrix packed with its own s_X — by the
``kernel_packed`` dict of 4-bit buffers that ``quant_mode="packed"``
models read: leaves (..., d_out, ·) and ``s_x`` of the stack's leading
shape.  Embeddings, norms, routers, biases and ``lm_head`` stay as they
are.  The packed bytes equal the reference's ``layers.pack_weight`` of
each matrix for the same float weights.

Two details of the reference's own ``pack_params`` are not followed:
it vmaps only a 3-D leaf, so a layer-stacked expert leaf (L, E, K, N)
reaches ``pack_weight`` whole and its ``.T`` reverses all four axes; and
it packs an untied ``lm_head``, which its packed forward then reads as a
float ``kernel`` (``transformer.lm_logits``).  The tree built here is the
layout the reference's packed forward reads (``moe.init_moe`` in packed
mode): expert leaves per (layer, expert), ``lm_head`` a float kernel.

``decode_scales`` adds to each ``kernel_packed`` dict its decoded dequant
scales, ``inv_scale``, once, so that a forward does not decode the E4M3
scale bytes of every weight on every call (``ops.packed_operand``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import bcq

EXCLUDE_TOKENS = ("embed", "norm", "router", "bias", "scale", "conv", "lru_a", "lm_head")
PACK_CHUNK = 1 << 24  # scalars encoded at once: bounds the plain encode's temporaries


def _is_gemm_weight(path: str, leaf: Any) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not path.endswith("kernel"):
        return False
    return not any(t in path for t in EXCLUDE_TOKENS)


def pack_stack(leaf: torch.Tensor, codebooks: torch.Tensor, cfg: bcq.BCQConfig) -> dict:
    """Pack a (..., K, N) stack of kernels, each (K, N) matrix with its own
    s_X (blocks along K), a few matrices at a time: the dict of
    ``layers.pack_weight`` with the stack's leading axes in front, and
    ``s_x`` of the leading shape.  Each matrix's bytes are those of
    ``pack_weight`` on it alone (the encode is elementwise given s_X, and
    s_X a max, so batching moves no bit)."""
    lead, (k, n) = leaf.shape[:-2], leaf.shape[-2:]
    flat = leaf.reshape((-1, k, n))
    step = max(1, PACK_CHUNK // (k * n))
    parts = []
    for i in range(0, flat.shape[0], step):
        wt = flat[i:i + step].transpose(-1, -2).float().contiguous()  # (m, N, K)
        s_x = torch.stack([bcq.tensor_scale(w, cfg) for w in wt])  # each matrix's s_X
        enc = bcq.encode(wt, codebooks, cfg, s_x=s_x[:, None, None])
        parts.append({"idx": enc.packed_idx, "sel": enc.packed_sel, "scale": enc.scale_code,
                      "s_x": s_x})
    return {name: torch.cat([p[name] for p in parts]).reshape(lead + parts[0][name].shape[1:])
            for name in parts[0]}


def pack_params(params: Any, codebooks: torch.Tensor, cfg: bcq.BCQConfig,
                predicate: Callable[[str, Any], bool] = _is_gemm_weight) -> Any:
    """Structural conversion to the ``quant_mode='packed'`` param tree."""
    from repro_torch.models import layers as _layers

    def pack_leaf(leaf):
        if leaf.ndim >= 3:  # a layer or expert stack: each matrix its own s_X
            return pack_stack(leaf, codebooks, cfg)
        return _layers.pack_weight(leaf, cfg, codebooks)

    def walk(tree, path=""):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif k == "kernel" and predicate(p, v):
                out["kernel_packed"] = pack_leaf(v)
            else:
                out[k] = v
        return out

    return walk(params)


def decode_scales(params: Any) -> Any:
    """The tree with ``inv_scale`` (``ops.decode_inv_scale``, per matrix of
    a stack) beside every ``kernel_packed`` dict's bytes; a dict that has
    it keeps it.  The bytes are shared, not copied."""
    from repro_torch.kernels.ops import decode_inv_scale

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: walk(v) for k, v in tree.items()}
        pk = out.get("kernel_packed")
        if isinstance(pk, dict) and "inv_scale" not in pk:
            out["kernel_packed"] = dict(pk, inv_scale=decode_inv_scale(pk))
        return out

    return walk(params)
