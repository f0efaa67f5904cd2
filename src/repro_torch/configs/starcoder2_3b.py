"""StarCoder2-3B — dense GQA kv=2, RoPE. [arXiv:2402.19173]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab=49152,
    qkv_bias=True, rope_theta=999999.4, act="gelu", norm="layernorm",
    source="arXiv:2402.19173",
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="starcoder2-3b-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    )
