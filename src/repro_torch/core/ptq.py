"""Post-training quantization of a parameter tree (counterpart of
``repro/core/ptq.py``).

Two layouts, each where the reference has it:

* the PTQ deploy step (``quantize_params``, ``encode_params``,
  ``count_quantized_bits``; ``launch/quantize.py``) follows the
  reference's ``ptq`` module exactly: its predicate (``_is_ptq_weight``:
  an untied ``lm_head`` is a GEMM weight there), and a layer-stacked leaf
  (L, K, N) or (L, E, K, N) fake-quantized or encoded as ONE tensor with
  ONE s_X.  ``packed_from_artifact`` turns such an encoding (the
  ``weights_w4_packed.npz`` artifact) into the tree the packed forward
  reads, the stack's one s_X broadcast over its leading axes;
* ``pack_params`` builds the ``quant_mode="packed"`` tree that ``zoo``
  serves: every GEMM ``kernel`` leaf (d_in, d_out) — or a stack of them,
  (L, d_in, d_out) per layer or (L, E, d_in, d_out) per layer and expert,
  each matrix packed with its own s_X — becomes the ``kernel_packed`` dict
  of 4-bit buffers: leaves (..., d_out, ·) and ``s_x`` of the stack's
  leading shape.  Embeddings, norms, routers, biases and ``lm_head`` stay
  as they are.  The packed bytes equal the reference's
  ``layers.pack_weight`` of each matrix for the same float weights.

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

import numpy as np
import torch

from repro_torch.core import bcq

PTQ_EXCLUDE_TOKENS = ("embed", "norm", "router", "bias", "scale", "conv", "lru_a")
EXCLUDE_TOKENS = PTQ_EXCLUDE_TOKENS + ("lm_head",)
PACK_CHUNK = 1 << 24  # scalars encoded at once: bounds the plain encode's temporaries


def _is_gemm_weight(path: str, leaf: Any, exclude=EXCLUDE_TOKENS) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not path.endswith("kernel"):
        return False
    return not any(t in path for t in exclude)


def _is_ptq_weight(path: str, leaf: Any) -> bool:
    """The reference ``ptq`` module's predicate (``lm_head`` included)."""
    return _is_gemm_weight(path, leaf, PTQ_EXCLUDE_TOKENS)


def _walk(tree: Any, fn: Callable[[str, Any], Any], path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}") for k, v in tree.items()}
    return fn(path, tree)


def quantize_params(params: Any, codebooks: torch.Tensor, cfg: bcq.BCQConfig,
                    predicate: Callable[[str, Any], bool] = _is_ptq_weight) -> Any:
    """Fake-quantize every GEMM weight of ``params`` (PTQ, no weight
    update): blocks along the reduction axis (d_in), one s_X per leaf —
    a layer stack is one tensor.  On the card the encode is the quantize
    kernel's (``bcq.fake_quant``)."""

    def fn(path, leaf):
        if not predicate(path, leaf):
            return leaf
        wq = bcq.fake_quant(leaf.transpose(-1, -2), codebooks, cfg)
        return wq.transpose(-1, -2).to(leaf.dtype).contiguous()

    return _walk(params, fn)


def encode_params(params: Any, codebooks: torch.Tensor, cfg: bcq.BCQConfig,
                  predicate: Callable[[str, Any], bool] = _is_ptq_weight) -> dict:
    """Packed W4 weights: path → (Encoded, shape of the (..., N, K) leaf
    encoded), one s_X per leaf (``bcq.encode``)."""
    out = {}

    def fn(path, leaf):
        if predicate(path, leaf):
            w = leaf.transpose(-1, -2).float().contiguous()
            out[path] = (bcq.encode(w, codebooks, cfg), tuple(w.shape))
        return leaf

    _walk(params, fn)
    return out


def count_quantized_bits(params: Any, cfg: bcq.BCQConfig) -> dict:
    """Storage accounting: bf16 baseline vs LO-BCQ bits (Eq. 9) of a tree."""
    total, quant = 0, 0

    def fn(path, leaf):
        nonlocal total, quant
        n = int(leaf.numel()) if isinstance(leaf, torch.Tensor) else int(np.size(leaf))
        total += n
        if _is_ptq_weight(path, leaf):
            quant += n
        return leaf

    _walk(params, fn)
    bw = cfg.bitwidth()
    return {
        "params": total,
        "gemm_params": quant,
        "bf16_bits": total * 16,
        "ptq_bits": quant * bw + (total - quant) * 16,
        "compression": (total * 16) / max(quant * bw + (total - quant) * 16, 1),
    }


def packed_from_artifact(params: Any, packed: dict) -> Any:
    """The ``quant_mode="packed"`` tree of a ``weights_w4_packed.npz``
    artifact (``launch.quantize``): ``packed`` maps a dotted leaf path
    (``layers.attn.wq.kernel``) to its encoding's ``idx`` / ``sel`` /
    ``scale`` / ``s_x`` — a stack encoded as one tensor with one s_X.  Every
    kernel the packed forward reads as packed (``pack_params``' predicate:
    ``lm_head`` stays float) is replaced by a ``kernel_packed`` dict whose
    ``s_x`` is that one s_X broadcast over the stack's leading axes, with
    its decoded scales (``decode_scales``); every other leaf comes from
    ``params`` (the fake-quant tree, or the float one)."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif k == "kernel" and _is_gemm_weight(p, v):
                enc = packed[p.strip("/").replace("/", ".")]
                lead = tuple(v.shape[:-2])
                out["kernel_packed"] = {
                    "idx": enc["idx"], "sel": enc["sel"], "scale": enc["scale"],
                    "s_x": torch.as_tensor(enc["s_x"], dtype=torch.float32,
                                           device=enc["idx"].device).expand(lead).contiguous()}
            else:
                out[k] = v
        return out

    return decode_scales(walk(params, ""))


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
