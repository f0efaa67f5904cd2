"""The frozen universal codebooks (paper §3), read from the port's copy.

Counterpart of ``repro/core/calibrate.default_universal_codebooks`` for
the serving side only: the port reads the committed JSON under
``repro_torch/configs/codebooks/`` and never fits, regenerates or writes
codebooks (calibration stays in the JAX package).
"""
from __future__ import annotations

import os

from repro_torch.core.bcq import BCQConfig, CodebookSet

_CB_DIR = os.path.join(os.path.dirname(__file__), "..", "configs", "codebooks")


def default_universal_codebooks(cfg: BCQConfig | None = None) -> CodebookSet:
    """The frozen universal codebooks for ``cfg`` (default: the paper's
    g64 / L_b 8 / N_c 8).  Raises FileNotFoundError for a config whose
    codebooks the port does not carry."""
    cfg = cfg or BCQConfig()
    path = os.path.join(_CB_DIR, f"universal_{cfg.tag()}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no frozen codebooks for {cfg.tag()} at {path}; the port only "
            "reads committed codebooks (fit them with the JAX package)"
        )
    return CodebookSet.load(path)
