"""RecurrentGemma-9B — RG-LRU + local attention, 1:2 ratio (2 recurrent
blocks per local-attention block), GQA kv=1 in attention blocks.
[arXiv:2402.19427]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, HybridSpec

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, d_head=256,
    rope_theta=10000.0, act="gelu", norm="rmsnorm",
    hybrid=HybridSpec(lru_width=4096, window=2048, pattern=("rec", "rec", "attn")),
    source="arXiv:2402.19427",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", n_layers=3, d_model=128,
        n_heads=4, n_kv_heads=1, d_ff=256, vocab=512, d_head=32,
        hybrid=HybridSpec(lru_width=128, window=32, pattern=("rec", "rec", "attn")),
    )
