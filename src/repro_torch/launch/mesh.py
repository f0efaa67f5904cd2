"""The device mesh, the collectives over its named axes, and the spec
layout helpers (counterpart of ``repro/launch/mesh.py``).

Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2, data=16,
model=16), 512 ranks; the ``pod`` axis is data-parallel by default
(optionally a pipeline, ``runtime/pipeline.py``).  A mesh is a
``torch.distributed.DeviceMesh`` over the default process group, which
``init_group`` brings up: from ``torchrun``'s environment when it is set,
else a world of one over an in-process store (no network).  The
dry-run's meshes sit on a fake process group of 256 or 512 ranks in one
process (``launch/dryrun.py``).

The collectives the port uses take an ``Axis`` (one named mesh axis as
this rank sees it, ``axis(mesh, name)``) or a tuple of them, as JAX's
take an axis name inside ``shard_map``: ``psum``, ``pmean``, ``pmax``,
``all_gather``, ``reduce_scatter`` and ``ppermute``.  Each one does nothing
on an axis of size 1 (it returns its input, no copy); counts the bytes of
its output, per device, under the reference's kinds (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``collective-permute``;
``repro/launch/roofline.py:29-33``) and the ranks of its group, in a
counter ``launch/roofline.py`` reads; and on a meta tensor returns a meta
tensor of the output's shape without communicating.  ``all_gather`` (and
so ``gather``) and ``ppermute`` carry a gradient: the backward of an
all-gather is a reduce-scatter, of a permutation the inverse
permutation.  The reductions return a tensor with no gradient.  A
reduce-scatter is an all-reduce and this rank's chunk on every backend.

A layout spec is the reference's ``PartitionSpec`` as plain data: a
tuple with one entry per leading dimension — None, an axis name, or a
tuple of names sharding that dimension jointly, major to minor — and
trailing dimensions replicated.  ``local_shape``, ``shard`` and
``gather`` move a tensor between its global and local forms.
"""
from __future__ import annotations

import dataclasses
import math
import os
from collections import defaultdict

import torch
import torch.distributed as dist

# (kind, ranks of the group) → bytes of the outputs, per device
_BYTES: dict = defaultdict(float)


def reset_collective_bytes() -> None:
    _BYTES.clear()


def collective_bytes() -> dict:
    """{(kind, ranks of the group): bytes} since the last reset."""
    return dict(_BYTES)


class ShardingError(ValueError):
    """A spec shards a dimension its axes do not divide (the dry-run's
    counterpart of an XLA sharding failure at compile time)."""


# ------------------------------------------------------------- the group
def init_group(device="cuda") -> torch.device:
    """Bring up the default process group and return this rank's device.

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) it joins that
    world, and a CUDA rank takes card ``LOCAL_RANK``; otherwise it starts
    a world of one over an in-process store.  A CUDA device uses NCCL —
    a failure there raises, it never falls back — and gloo runs only
    where the caller asks for the CPU.  An initialized group is kept."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "port's plain PyTorch versions on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"init_group: unsupported device {device}")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend} for "
                               f"{device}")
        return device
    extra = {"device_id": device} if device.type == "cuda" else {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **extra)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **extra)
    return device


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple, names: tuple, ranks=None):
    """A ``DeviceMesh`` of ``shape`` over ``ranks`` (default: the first
    prod(shape) ranks of the world), in row-major order, axes ``names``."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    ranks = torch.arange(n) if ranks is None else torch.as_tensor(list(ranks))
    if ranks.numel() != n:
        raise ValueError(f"a mesh of {shape} needs {n} ranks, got {ranks.numel()}")
    return DeviceMesh(_device_type(), ranks.reshape(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


_SIZES: dict = {}


def _sizes(mesh) -> dict:
    if id(mesh) not in _SIZES:
        _SIZES[id(mesh)] = (mesh, axis_sizes(mesh))
    return _SIZES[id(mesh)][1]


def data_axes(mesh) -> tuple:
    """Axes that shard the batch: ('pod', 'data') multi-pod, else ('data',)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


# -------------------------------------------------------------- the axes
@dataclasses.dataclass(frozen=True)
class Axis:
    """One named axis of a mesh as this rank sees it: its size, this
    rank's index along it, the global ranks of its group (in axis order)
    and the group (None on an axis of size 1)."""

    name: str
    size: int
    index: int
    ranks: tuple
    group: object = None


_AXES: dict = {}


def axis(mesh, name: str) -> Axis:
    key = (id(mesh), name)
    if key not in _AXES:
        i = mesh.mesh_dim_names.index(name)
        size = int(mesh.mesh.shape[i])
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in this mesh")
        line = mesh.mesh.movedim(i, -1)[tuple(c for j, c in enumerate(coord) if j != i)]
        group = mesh.get_group(name) if size > 1 else None
        _AXES[key] = (mesh, Axis(name, size, int(coord[i]), tuple(int(r) for r in line), group))
    return _AXES[key][1]


def _each(ax):
    return ax if isinstance(ax, tuple) else (ax,)


def _record(kind: str, ax: Axis, out: torch.Tensor) -> None:
    _BYTES[(kind, ax.ranks)] += out.numel() * out.element_size()


def _meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


# ----------------------------------------------------------- collectives
def _all_reduce(x: torch.Tensor, ax: Axis, op) -> torch.Tensor:
    _record("all-reduce", ax, x)
    if _meta(x):
        return torch.empty_like(x)
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=ax.group)
    return y


def psum(x: torch.Tensor, ax) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the axis (or axes, in turn)."""
    for a in _each(ax):
        if a.size > 1:
            x = _all_reduce(x, a, dist.ReduceOp.SUM)
    return x


def pmean(x: torch.Tensor, ax) -> torch.Tensor:
    """The mean of ``x`` over the axes (the sum over a tensor of the size,
    as the reference's ``psum`` / ``psum(1)``)."""
    n = math.prod(a.size for a in _each(ax))
    if n == 1:
        return x
    return psum(x, ax) / torch.full((), float(n), dtype=x.dtype, device=x.device)


def pmax(x: torch.Tensor, ax) -> torch.Tensor:
    """The elementwise max over the axes; no gradient (a decode statistic)."""
    for a in _each(ax):
        if a.size > 1:
            x = _all_reduce(x, a, dist.ReduceOp.MAX)
    return x


def _gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] *= ax.size
    if _meta(x):
        out = x.new_empty(shape)
    else:
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x.detach().contiguous(), group=ax.group)
        out = torch.cat(parts, dim)
    _record("all-gather", ax, out)
    return out


def _scatter(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    if shape[dim] % ax.size:
        raise ShardingError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} over {ax.size} ranks")
    shape[dim] //= ax.size
    if _meta(x):
        out = x.new_empty(shape)
    else:
        y = x.detach().clone()
        dist.all_reduce(y, group=ax.group)
        out = y.chunk(ax.size, dim)[ax.index].clone()
    _record("reduce-scatter", ax, out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.ax, ctx.dim), None, None


def all_gather(x: torch.Tensor, ax, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in axis order (JAX's
    ``all_gather(..., tiled=True)``); over several axes, the last
    (minor) first."""
    for a in reversed(_each(ax)):
        if a.size > 1:
            x = _AllGather.apply(x, a, dim)
    return x


def reduce_scatter(x: torch.Tensor, ax, dim: int = 0) -> torch.Tensor:
    """The sum over the ranks, of which each keeps its chunk along ``dim``
    (JAX's ``psum_scatter(..., tiled=True)``); no gradient."""
    for a in _each(ax):
        if a.size > 1:
            x = _scatter(x, a, dim)
    return x


def _permute(x: torch.Tensor, ax: Axis, perm: tuple) -> torch.Tensor:
    out = torch.zeros_like(x)
    _record("collective-permute", ax, out)
    if _meta(x):
        return out
    ops = []
    for src, dst in perm:
        if src == ax.index:
            ops.append(dist.P2POp(dist.isend, x.detach().contiguous(), ax.ranks[dst], ax.group))
        if dst == ax.index:
            ops.append(dist.P2POp(dist.irecv, out, ax.ranks[src], ax.group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _permute(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.ax, tuple((d, s) for s, d in ctx.perm)), None, None


def ppermute(x: torch.Tensor, ax: Axis, perm) -> torch.Tensor:
    """JAX's ``ppermute``: rank ``src`` of the axis sends ``x`` to rank
    ``dst`` for each (src, dst) of ``perm``; a rank that receives nothing
    gets zeros."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if ax.size == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, ax, perm)


# ------------------------------------------------------------ the layout
def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, sizes: dict) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor laid out by
    ``spec`` over a mesh of axis ``sizes``; a dimension that its axes do
    not divide raises ``ShardingError``."""
    out = list(shape)
    if len(spec) > len(shape):
        raise ShardingError(f"spec {spec} has more entries than shape {tuple(shape)}")
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _names(entry))
        if out[d] % n:
            raise ShardingError(f"dim {d} of {tuple(shape)} ({out[d]}) does not divide over "
                                f"{_names(entry)} ({n} ranks): spec {spec}")
        out[d] //= n
    return tuple(out)


def shard(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` (a view; ``t`` itself
    where the spec shards nothing of size > 1)."""
    sizes = _sizes(mesh)
    if all(sizes[a] == 1 for entry in spec for a in _names(entry)):
        return t
    local_shape(t.shape, spec, sizes)
    for d, entry in enumerate(spec):
        names = _names(entry)
        n = math.prod(sizes[a] for a in names)
        if n == 1:
            continue
        idx = 0
        for a in names:
            idx = idx * sizes[a] + axis(mesh, a).index
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t


def gather(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The global tensor from each rank's block ``t`` (``t`` itself where
    nothing of size > 1 is sharded): all-gathers along each sharded
    dimension."""
    for d, entry in enumerate(spec):
        names = _names(entry)
        if names:
            t = all_gather(t, tuple(axis(mesh, a) for a in names), dim=d)
    return t


def tree_map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, tuples and lists and its
    spec tree."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)
