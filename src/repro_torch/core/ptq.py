"""Offline packing of a parameter tree to W4 (counterpart of ``repro/core/ptq.py``).

``pack_params`` replaces every GEMM ``kernel`` leaf (d_in, d_out) — or a
layer stack (L, d_in, d_out), packed per layer with its own s_X — by the
``kernel_packed`` dict of 4-bit buffers that ``quant_mode="packed"``
models read.  Embeddings, norms and biases stay as they are.  The packed
bytes equal the reference's for the same float weights.

``decode_scales`` adds to each ``kernel_packed`` dict its decoded dequant
scales, ``inv_scale``, once, so that a forward does not decode the E4M3
scale bytes of every weight on every call (``ops.packed_operand``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import bcq

EXCLUDE_TOKENS = ("embed", "norm", "router", "bias", "scale", "conv", "lru_a")


def _is_gemm_weight(path: str, leaf: Any) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not path.endswith("kernel"):
        return False
    return not any(t in path for t in EXCLUDE_TOKENS)


def pack_params(params: Any, codebooks: torch.Tensor, cfg: bcq.BCQConfig,
                predicate: Callable[[str, Any], bool] = _is_gemm_weight) -> Any:
    """Structural conversion to the ``quant_mode='packed'`` param tree."""
    from repro_torch.models import layers as _layers

    def pack_leaf(leaf):
        if leaf.ndim == 3:  # layer stack: pack each layer, stack the dicts
            per = [_layers.pack_weight(w, cfg, codebooks) for w in leaf]
            return {k: torch.stack([p[k] for p in per]) for k in per[0]}
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
    """The tree with ``inv_scale`` (``ops.decode_inv_scale``, per layer of
    a stack) beside every ``kernel_packed`` dict's bytes; a dict that has
    it keeps it.  The bytes are shared, not copied."""
    from repro_torch.kernels.ops import decode_inv_scale

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: walk(v) for k, v in tree.items()}
        pk = out.get("kernel_packed")
        if isinstance(pk, dict) and "inv_scale" not in pk:
            if pk["idx"].ndim == 3:
                inv = torch.stack([decode_inv_scale({k: v[i] for k, v in pk.items()})
                                   for i in range(pk["idx"].shape[0])])
            else:
                inv = decode_inv_scale(pk)
            out["kernel_packed"] = dict(pk, inv_scale=inv)
        return out

    return walk(params)
