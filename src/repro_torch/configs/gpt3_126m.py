"""GPT3-126M — the paper's calibration model (§4.1): codebooks are fitted
on one batch of its activations and frozen universally."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gpt3-126m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=50304,
    act="gelu", norm="layernorm", tie_embeddings=True, source="paper §4.1",
)

def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="gpt3-126m-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    )
