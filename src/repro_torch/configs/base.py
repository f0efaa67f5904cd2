"""Architecture registry: the ``ArchConfig`` dataclass and its lookup.

A copy of ``repro/configs/base.py``'s records, ``ARCH_IDS`` and its
dry-run shapes (``ShapeConfig``, ``SHAPES``, ``cell_is_applicable``): the
port reads nothing of the JAX package, so it keeps its own config
records.  Each config module provides ``CONFIG``
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
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 255) // 256) * 256  # pad for clean sharding

    def param_count(self) -> int:
        """Approximate total parameters (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.family == "ssm":
            di = self.ssm.expand * d
            blk = d * (2 * di + 2 * self.ssm.d_state + di // self.ssm.head_dim) + di * d
        elif self.family == "moe":
            blk = attn + self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        elif self.family == "hybrid":
            lw = self.hybrid.lru_width or d
            rec = 2 * d * lw + 2 * lw + lw * d
            n_attn = sum(1 for p in self.hybrid.pattern if p == "attn")
            n_rec = len(self.hybrid.pattern) - n_attn
            blk = (n_attn * attn + n_rec * rec) / len(self.hybrid.pattern) + 3 * d * f
        else:
            mlp_mult = 3 if self.act == "swiglu" else 2
            blk = attn + mlp_mult * d * f
        total = self.n_layers * blk + v * d * (1 if self.tie_embeddings else 2)
        if self.family == "encdec":
            total += self.n_encoder_layers * (attn + 2 * d * f) + self.n_layers * attn  # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        return int(dense + self.n_layers * self.moe.top_k * 3 * d * self.moe.d_ff_expert)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


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


def cell_is_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch × shape) dry-run cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "full quadratic attention — 500k decode assigned to SSM/hybrid only"
    return True, ""
