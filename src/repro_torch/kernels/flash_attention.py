"""Flash attention (causal or full) over contiguous Q/K/V.

Counterpart of ``repro/kernels/flash_attention.py``: the self-attention
of a forward without a cache (``Runtime(flash_kernel=True)``, the
held-out evaluation forward).  ``flash_attention_kernel`` launches
csrc/flash_attention.cu (design notes in the source): bf16 inputs on the
bf16 tensor cores (``mma.sync``, P rounded to bf16 for the P·V product),
f32 inputs on the CUDA cores in f32;
``flash_attention_plain`` computes the same function in plain PyTorch;
``flash_attention`` takes (B, S, H, D), repeats K/V heads for GQA and
dispatches by device: CPU tensors run the plain version, CUDA tensors
the kernel (or raise), meta tensors (the dry-run) the kernel's meta
branch, which adds ``flash_cost`` to the build's meta count.

Semantics (``flash_attention.py:23-59``): scores q·k·dh^-0.5 in f32,
masked where a key lies after the query (causal) with the finite
``-1e30``, softmax as ``exp(s - max)`` over ``max(l, 1e-30)``, the
result in q's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

FLASH_ATTENTION = build.counter("flash_attention")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_cost(bh: int, s_len: int, d: int, dtype, causal: bool = True) -> tuple:
    """(HBM bytes, operations by unit): q, k, v read once and out written
    once; q·k and p·v over the (causally) visible pairs, on the bf16 tensor
    cores for bf16 inputs and the f32 CUDA cores for f32 ones."""
    item = torch.empty((), dtype=dtype).element_size()
    pairs = s_len * (s_len + 1) // 2 if causal else s_len * s_len
    unit = "bf16" if dtype == torch.bfloat16 else "f32"
    return 4 * bh * s_len * d * item, {unit: 4 * d * pairs * bh}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q, k, v (BH, S, dh) → (BH, S, dh) in q's dtype, computed in f32:
    the model's masked softmax (``layers._attend_chunked``), one head per row."""
    from repro_torch.models.layers import _attend_chunked

    bh, s_len = q.shape[:2]
    pos = torch.arange(s_len, device=q.device)[None].expand(bh, s_len)
    out = _attend_chunked(q[:, :, None], k[:, :, None], v[:, :, None], pos, s_len, causal)
    return out[:, :, 0]


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on (BH, S, dh) CUDA tensors of one dtype
    (f32 or bf16), dh in {32, 64, 128}; any S.  bf16 tensors not on a
    16-byte boundary are copied first (the tensor-core kernel reads
    16-byte chunks).  No backward: inputs that require grad under autograd
    raise."""
    build.refuse_grad("flash_attention kernel", q, k, v)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention kernel: unsupported device {q.device}")
    if q.ndim != 3 or q.dtype not in _DTYPE_CODE or q.shape[2] not in (32, 64, 128):
        raise ValueError(f"flash_attention kernel: unsupported q {tuple(q.shape)} {q.dtype}")
    bh, s_len, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_tensor(f"flash_attention kernel: {name}", t, q.dtype, (bh, s_len, d), q.device)
    if q.device.type == "meta":
        build.add_meta_cost("flash_attention", *flash_cost(bh, s_len, d, q.dtype, causal))
        return torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        q, k, v = (build.aligned(t, 16) for t in (q, k, v))
    out = torch.empty_like(q)
    if bh == 0 or s_len == 0:
        return out
    status = build.library().flash_attention_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, s_len, d, int(causal), d**-0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(status, "flash_attention_launch")
    FLASH_ATTENTION.count += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(B, S, H, D) wrapper with GQA head replication: k/v (B, S, Hkv, D).
    Returns (B, S, H, D) in q's dtype.  The kernel has no backward (nor has
    the reference's), so inputs that require grad under autograd raise on
    either device; the training forward runs the masked softmax."""
    build.refuse_grad("flash_attention", q, k, v)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, s_len, h, d = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)

    def heads_first(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], d).contiguous()

    fn = flash_attention_plain if q.device.type == "cpu" else flash_attention_kernel
    out = fn(heads_first(q), heads_first(k), heads_first(v), causal)
    return out.reshape(b, h, s_len, d).transpose(1, 2)
