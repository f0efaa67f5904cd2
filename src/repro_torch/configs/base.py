"""Architecture registry: the ``ArchConfig`` dataclass and its lookup.

A copy of ``repro/configs/base.py``'s records and ``ARCH_IDS`` (its
dry-run shapes aside): the port reads nothing of the JAX package, so it
keeps its own config records.  Each config module provides ``CONFIG``
(the published shape) and ``smoke()`` (a 2-layer reduction for CPU
tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    lru_width: int = 0  # 0 → d_model
    window: int = 2048
    pattern: tuple = ("rec", "rec", "attn")  # RecurrentGemma 1:2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    hybrid: Optional[HybridSpec] = None
    n_encoder_layers: int = 0  # enc-dec only
    encoder_len: int = 1500  # whisper frame count (stub frontend)
    n_patches: int = 256  # vlm stub patch count
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 255) // 256) * 256  # pad for clean sharding


ARCH_IDS = [
    "qwen1_5_32b",
    "starcoder2_3b",
    "phi3_medium_14b",
    "qwen2_0_5b",
    "qwen3_moe_235b",
    "moonshot_v1_16b",
    "pixtral_12b",
    "mamba2_130m",
    "recurrentgemma_9b",
    "whisper_base",
]


def get_arch(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.smoke()
