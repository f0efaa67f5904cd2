"""Pixtral-12B — VLM: pixtral-ViT frontend (STUB: precomputed patch
embeddings per assignment) + Mistral-Nemo-style 40L decoder backbone.
[hf:mistralai/Pixtral-12B-2409]"""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, d_head=128,
    rope_theta=1000000000.0, act="swiglu", norm="rmsnorm",
    n_patches=256, source="hf:mistralai/Pixtral-12B-2409",
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="pixtral-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, d_head=32, n_patches=8,
    )
