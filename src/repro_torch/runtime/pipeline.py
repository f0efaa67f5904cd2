"""GPipe pipeline parallelism over a mesh axis (counterpart of
``repro/runtime/pipeline.py``).

At multi-pod scale the 'pod' axis crosses nodes; instead of the
data-parallel gradient all-reduce (the default) a pipeline keeps only
activations on the slow links.  The layer stack is split into
``n_stages`` contiguous stages, stage s on rank s of the axis, and a
microbatched loop runs the classic GPipe fill / steady / drain schedule:
at tick t, stage s runs microbatch t − s and sends its output to stage
s + 1 (``mesh.ppermute``).

The ticks are written out, as the reference's ``lax.scan``: every rank
runs every tick's ``stage_fn`` and permutation, and selects its input by
a tensor mask, so all ranks record the same autograd graph and the
backward's permutations (the inverse ones) pair up.  ``pipeline_apply``
is differentiable.  Bubble fraction = (S − 1) / (T + S − 1): choose
microbatches T ≫ stages S.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim.adamw import tree_map


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank (an all-reduce of them,
    zeros elsewhere, as the reference's ``psum``).  The caller's loss is
    the same on every rank, so the backward keeps each rank's cotangent,
    and the mask before it passes the last stage's on."""

    @staticmethod
    def forward(ctx, x, ax):
        return mesh_lib.psum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh, axis: str = "pod",
                   n_micro: int | None = None) -> torch.Tensor:
    """Run ``x`` through the pipelined stages of ``axis``.

    stage_fn(params_stage, x_micro) -> y_micro — one stage's computation,
    shape-preserving.  stage_params: this rank's slice of the
    stage-stacked tree (leaves with a leading dim of 1, as
    ``mesh.shard(stacked, mesh, (axis,))`` gives).  x: (B, ...) the global
    batch, the same on every rank, split into ``n_micro`` microbatches
    (default: n_stages).  Returns y with x's shape on every rank.  The
    gradient reaches each rank's stage params, and x's on the first stage."""
    ax = mesh_lib.axis(mesh, axis)
    n_stages = ax.size
    b = x.shape[0]
    n_micro = n_micro or n_stages
    if b % n_micro:
        raise ValueError(f"pipeline_apply: batch {b} does not split into {n_micro} microbatches")
    mb = b // n_micro
    xs = x.reshape(n_micro, mb, *x.shape[1:])
    params_me = tree_map(lambda a: a[0], stage_params)
    first = torch.tensor(ax.index == 0, device=x.device)
    last = torch.tensor(ax.index == n_stages - 1, device=x.device)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    inflight = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t while there is one; others take the
        # activation stage s − 1 sent at tick t − 1
        x_in = torch.where(first, xs[t], inflight) if t < n_micro else inflight
        y = stage_fn(params_me, x_in)
        inflight = mesh_lib.ppermute(y, ax, perm)
        emit = t - (n_stages - 1)  # the last stage emits microbatch t − (S − 1)
        if 0 <= emit < n_micro:
            outs[emit] = torch.where(last, y, outs[emit])
    outs = torch.stack(outs)
    outs = _FromLast.apply(torch.where(last, outs, torch.zeros_like(outs)), ax)
    return outs.reshape(b, *x.shape[1:])


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
