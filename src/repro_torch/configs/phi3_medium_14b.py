"""Phi-3-medium-14B — dense GQA kv=10, RoPE, SwiGLU. [arXiv:2404.14219]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352,
    rope_theta=10000.0, act="swiglu", norm="rmsnorm",
    source="arXiv:2404.14219",
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="phi3-medium-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    )
