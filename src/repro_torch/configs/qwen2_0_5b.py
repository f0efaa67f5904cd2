"""Qwen2-0.5B — dense GQA kv=2, QKV bias, tied embeddings. [arXiv:2407.10671]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151936,
    qkv_bias=True, rope_theta=1000000.0, act="swiglu", norm="rmsnorm",
    tie_embeddings=True, source="arXiv:2407.10671",
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-0.5b-smoke", n_layers=2, d_model=112,
        n_heads=7, n_kv_heads=1, d_ff=256, vocab=512, d_head=16,
    )
