"""Paged decode attention: the C == 1 case of the page-gather core.

Counterpart of ``repro/kernels/paged_attention.py``.  A decode query at
position ``len - 1`` under the core's ``tpos <= qpos`` mask sees exactly
the ``len`` live tokens of its pages.  CUDA tensors run
csrc/page_gather.cu; CPU tensors its plain version
(``common.page_gather_attention_plain``).
"""
from __future__ import annotations

import torch

from repro_torch.core.bcq import BCQConfig
from repro_torch.kernels.common import page_gather_attention


def paged_attention(q: torch.Tensor, pool: dict, block_tables, lengths, kind: str,
                    cfg: BCQConfig, cb=None) -> torch.Tensor:
    """Paged decode attention: q (B, H, D) against a single-layer page pool.

    pool leaves: (n_pages, page_size, Hkv, ...); block_tables (B, MAXP)
    int32; lengths (B,) live tokens per sequence.  Returns (B, H, D) f32."""
    return page_gather_attention(q[:, None], pool, block_tables, lengths, kind, cfg, cb)[:, 0]
