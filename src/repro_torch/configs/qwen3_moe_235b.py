"""Qwen3-MoE-235B-A22B — 128 experts top-8, GQA kv=4. [hf:Qwen/Qwen3-235B-A22B]"""
import dataclasses
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, d_head=128,
    rope_theta=1000000.0, act="swiglu", norm="rmsnorm",
    moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=1536),
    source="hf:Qwen/Qwen3-235B-A22B",
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, d_head=32,
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=128),
    )
