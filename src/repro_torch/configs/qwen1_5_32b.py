"""Qwen1.5-32B — dense, full MHA (kv=40), QKV bias. [hf:Qwen/Qwen1.5-32B]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab=152064,
    qkv_bias=True, rope_theta=1000000.0, act="swiglu", norm="rmsnorm",
    source="hf:Qwen/Qwen1.5-32B",
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen1.5-32b-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    )
