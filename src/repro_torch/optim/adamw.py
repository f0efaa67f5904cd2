"""AdamW with a warmup-cosine schedule and global-norm clipping, on nested
dicts of tensors (counterpart of ``repro/optim/adamw.py``).

The state mirrors the parameter tree: f32 first and second moments per
leaf and an int32 step, the reference's layout, so a checkpoint of
``{"params", "opt"}`` has the reference's leaves.  The math is the
reference's, operation for operation in f32: clipping by the global norm
of the gradients, bias correction as ``b ** step``, decoupled weight
decay on every float leaf of two or more dimensions (the ``codebooks`` of
W4A4 fake-quant training included), integer leaves (packed W4 buffers)
passed through untouched.

``apply_updates`` is out of place: it returns new trees and leaves its
arguments as they were, as the reference's immutable arrays are.  A
preemption snapshot taken between two bytecodes of the train loop then
sees either the whole old step or the whole new one, never a tree half
updated (``launch.train`` swaps its snapshot reference once a step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.serving.pages import tree_leaves  # sorted-key order, jax.tree.leaves's


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of equally nested dicts, in sorted-key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def _over(a: torch.Tensor, c: int) -> torch.Tensor:
    """a / c as the reference's jitted step computes it: XLA compiles a
    division by a constant into a product with the constant's f32
    reciprocal."""
    one = torch.ones((), dtype=torch.float32, device=a.device)
    return a * (one / torch.full_like(one, c))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio``; f32 0-d."""
    s = step.to(torch.float32)
    warm = _over(s, max(cfg.warmup_steps, 1))
    prog = torch.clamp(_over(s - cfg.warmup_steps, max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_state(params: Any) -> dict:
    """f32 zero moments for every leaf and step 0 (int32), on the leaves'
    devices."""
    def zeros(p):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), p)

    device = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (f32), leaves summed
    in tree order from 0 as the reference's Python ``sum``; None leaves
    (no gradient) count nothing."""
    total = 0
    for x in tree_leaves(tree):
        if x is not None:
            total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                  grad_norm: torch.Tensor | None = None):
    """One AdamW step → (new params, new state, {"grad_norm", "lr"}).
    Integer and bool leaves (packed W4 buffers; their gradient is None)
    pass through untouched, their moments too; float leaves get decoupled
    weight decay except 1-D (norm and bias) leaves.  Out of place.
    ``grad_norm``: the global gradient norm, where ``grads`` are one
    rank's shards of the gradients it was taken of (the sharded step);
    else it is ``global_norm(grads)``."""
    with torch.no_grad():
        step = state["step"] + 1
        lr = schedule(cfg, step)
        gn = global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp(torch.full_like(gn, cfg.clip_norm) / torch.clamp(gn, min=1e-12),
                            max=1.0)
        step_f = step.to(torch.float32)
        bc1 = 1 - cfg.b1 ** step_f
        bc2 = 1 - cfg.b2 ** step_f

        def upd(p, g, m, v):
            # the reference's expressions, op by op and in its order, but in
            # place on this function's own temporaries, so that at most four
            # leaf-sized ones are live at once (a 1 B-parameter embedding
            # otherwise holds ~8 × 4 GB at its update)
            if not p.is_floating_point():
                return p, m, v
            g = g.to(torch.float32) * scale
            t = (1 - cfg.b2) * g
            t.mul_(g)
            v2 = cfg.b2 * v
            v2.add_(t)  # b2·v + (1 − b2)·g·g
            del t
            m2 = cfg.b1 * m
            m2.add_((1 - cfg.b1) * g)  # b1·m + (1 − b1)·g
            del g
            den = v2 / bc2
            den.sqrt_().add_(cfg.eps)
            delta = m2 / bc1
            delta.div_(den)  # m̂ / (sqrt(v̂) + ε)
            del den
            if p.ndim >= 2:
                delta.add_(cfg.weight_decay * p.to(torch.float32))
            delta.mul_(lr)
            return (p.to(torch.float32) - delta).to(p.dtype), m2, v2

        out = tree_map(lambda p, g, m, v: upd(p, g, m, v), params, grads, state["m"], state["v"])

        def part(i):
            return tree_map(lambda o: o[i], out)

    return part(0), {"m": part(1), "v": part(2), "step": step}, {"grad_norm": gn, "lr": lr}
