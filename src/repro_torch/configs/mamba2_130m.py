"""Mamba2-130M — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    norm="rmsnorm", ssm=SSMSpec(d_state=128, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True, source="arXiv:2405.21060",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=128, vocab=512,
        ssm=SSMSpec(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
    )
