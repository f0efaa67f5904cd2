"""Whisper-base — encoder-decoder; the conv audio frontend is a stub (the
model takes precomputed frame embeddings). [arXiv:2212.04356]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
    act="gelu", norm="layernorm", n_encoder_layers=6, encoder_len=1500,
    tie_embeddings=True, source="arXiv:2212.04356",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        n_encoder_layers=2, encoder_len=64,
    )
