"""Chunked prefill attention: the C > 1 case of the page-gather core.

Counterpart of ``repro/kernels/chunked_prefill.py``.  Query c of the
chunk sits at ``n_past + c`` and sees page token t iff ``t <= n_past + c``:
prefix tokens are visible to the whole chunk, chunk tokens mask causally,
and anything past the written tail is hidden.  CUDA tensors run
csrc/page_gather.cu; CPU tensors its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.bcq import BCQConfig
from repro_torch.kernels.common import page_gather_attention


def chunked_prefill(q: torch.Tensor, pool: dict, block_tables, n_past, kind: str,
                    cfg: BCQConfig, cb=None) -> torch.Tensor:
    """Chunked prefill attention: q (B, C, H, D) against a single-layer
    pool whose pages already hold the chunk's own K/V; n_past (B,) tokens
    before the chunk.  Returns (B, C, H, D) f32."""
    kv_len = n_past.to(torch.int32) + q.shape[1]
    return page_gather_attention(q, pool, block_tables, kv_len, kind, cfg, cb)
