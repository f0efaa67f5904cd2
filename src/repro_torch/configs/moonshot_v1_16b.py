"""Moonlight-16B-A3B (moonshot) — MoE 64 experts top-6, MHA kv=16.
[hf:moonshotai/Moonlight-16B-A3B]"""
import dataclasses
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840,
    rope_theta=50000.0, act="swiglu", norm="rmsnorm",
    moe=MoESpec(n_experts=64, top_k=6, d_ff_expert=1408),
    source="hf:moonshotai/Moonlight-16B-A3B",
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="moonshot-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=128),
    )
