"""int8 error-feedback gradient compression for the cross-pod all-reduce
(counterpart of ``repro/optim/compress.py``).

At multi-pod scale the 'pod' axis crosses nodes, whose links are much
slower than the links inside one, so the pod-axis gradient all-reduce is
the slow collective.  ``compressed_allreduce_local`` quantizes a gradient
to int8 with one f32 scale per ``CHUNK`` before the all-reduce (4× fewer
bytes than f32 gradients on the payload) and keeps the quantization
residual in an error-feedback buffer, so compression noise stays unbiased
over steps (Karimireddy et al., error feedback fixes signSGD).

The arithmetic is the reference's operation for operation: divisions stay
divisions, ``torch.round`` rounds half to even as ``jnp.round`` does, the
payload is summed as int32 (an all-reduce) and the scales as f32, left
to right in rank order (an all-gather of them, then the sum), as XLA
sums them: the result is the reference's bit for bit on any backend.  Each rank calls it on
its own gradient (the reference's body inside ``shard_map``); the
collectives are ``launch/mesh.py``'s, over an ``Axis``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.launch import mesh as mesh_lib

CHUNK = 2048


def _quantize_int8(x: torch.Tensor):
    """Per-CHUNK symmetric int8 quantization of a flat f32 vector."""
    n = x.shape[0]
    pad = (-n) % CHUNK
    xf = torch.nn.functional.pad(x, (0, pad)).reshape(-1, CHUNK)
    m = xf.abs().amax(dim=1, keepdim=True)
    s = m / torch.full_like(m, 127.0)  # a tensor: torch multiplies by a scalar's reciprocal
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s, n


def _dequantize(q, s, n):
    return (q.to(torch.float32) * s).reshape(-1)[:n]


def compressed_allreduce_local(g: torch.Tensor, err: torch.Tensor, axis):
    """Error-feedback int8 all-reduce of this rank's ``g`` over ``axis``
    (a ``mesh.Axis``): (the mean gradient in ``g``'s dtype and shape, the
    new error buffer).  An int32 sum of the int8 payload, an ordered sum
    of the scales; each rank contributed its own scale, so the mean scale
    dequantizes."""
    flat = g.reshape(-1).to(torch.float32) + err.reshape(-1)
    q, s, n = _quantize_int8(flat)
    local = _dequantize(q, s, n)
    new_err = (flat - local).reshape(g.shape)
    tot = mesh_lib.psum(q.to(torch.int32), axis)
    # the scales' sum left to right in rank order, as XLA's psum takes it:
    # an all-reduce's order follows the backend's algorithm (gloo's ring,
    # NCCL's topology), so the scales (1/CHUNK of the payload) are gathered
    scales = mesh_lib.all_gather(s[None], axis, dim=0)
    s_tot = scales[0]
    for i in range(1, scales.shape[0]):
        s_tot = s_tot + scales[i]
    size = torch.full((), float(axis.size), dtype=torch.float32, device=g.device)
    mean = (tot.to(torch.float32) * (s_tot / size)).reshape(-1)[:n] / size
    return mean.reshape(g.shape).to(g.dtype), new_err


def make_compressed_psum(mesh, axis_name: str = "pod"):
    """f(grad, err) -> (mean grad, new err) over ``axis_name`` of ``mesh``;
    every rank of the axis holds the whole gradient (the usual
    data-parallel layout after the in-pod reduction)."""
    ax = mesh_lib.axis(mesh, axis_name)

    def f(g, err):
        return compressed_allreduce_local(g, err, ax)

    return f


def init_error_state(params: Any) -> Any:
    """f32 zeros for every float leaf, None for the others."""
    if isinstance(params, dict):
        return {k: init_error_state(v) for k, v in params.items()}
    if params.is_floating_point():
        return torch.zeros(params.shape, dtype=torch.float32, device=params.device)
    return None


def compress_grads_tree(grads: Any, err: Any, psum_fn) -> tuple[Any, Any]:
    """The compressed all-reduce leaf by leaf (float leaves with an error
    buffer only): (gradients, error buffers)."""
    if isinstance(grads, dict):
        pairs = {k: compress_grads_tree(grads[k], err[k], psum_fn) for k in grads}
        return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
    if err is None or grads is None or not grads.is_floating_point():
        return grads, err
    return psum_fn(grads, err)
