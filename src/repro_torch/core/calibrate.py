"""Universal-codebook calibration (paper §3), in PyTorch.

Counterpart of ``repro/core/calibrate.py``.  The paper calibrates one set
of codebooks on one batch of GPT3-126M activations and weights, and
freezes it for every tensor, layer and model:

* ``capture_gemm_inputs`` runs a dense forward and keeps the first
  scalars of every GEMM input (the embedding output, each layer's ln1
  and ln2 outputs);
* ``calibrate_from_model`` adds the first scalars of every layer-stacked
  kernel and fits LO-BCQ codebooks on them (``calibrate_universal`` →
  ``bcq.fit_lobcq``);
* ``default_universal_codebooks`` is the committed set under
  ``repro_torch/configs/codebooks/`` (a byte copy of the reference's
  file): read as it is, or, with ``regenerate=True``, fitted anew from the
  reference's synthetic heavy-tailed mixture and written there.  Point
  ``_CB_DIR`` elsewhere before regenerating: the committed g64 / L_b 8 /
  N_c 8 file is what the parity tests hold both packages to.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch

from repro_torch.core.bcq import BCQConfig, CodebookSet, fit_lobcq

_CB_DIR = os.path.join(os.path.dirname(__file__), "..", "configs", "codebooks")


def calibrate_universal(samples: Sequence, cfg: BCQConfig, key: torch.Tensor | None = None,
                        **fit_kw) -> CodebookSet:
    return fit_lobcq(list(samples), cfg, key=key, **fit_kw)


def _cache_path(cfg: BCQConfig) -> str:
    return os.path.join(_CB_DIR, f"universal_{cfg.tag()}.json")


def _mixture_samples() -> list:
    """The reference's synthetic calibration mixture, in kind: gaussian
    weights, laplace (· 0.7) and student-t with 4 degrees of freedom
    (· 0.5) activations, and a gaussian with an outlier channel (· 8),
    drawn from a torch generator seeded 1234 (the reference draws them
    with ``jax.random``, so a regenerated set is the port's own)."""
    g = torch.Generator().manual_seed(1234)
    n = 1 << 18
    gauss = torch.randn(n, generator=g)
    u = torch.rand(n, generator=g) * 2.0 - 1.0
    lap = torch.sign(u) * torch.log1p(-u.abs()) * 0.7
    chi2 = (torch.randn((4, n), generator=g) ** 2).sum(0)
    t4 = torch.randn(n, generator=g) / torch.sqrt(chi2 / 4.0) * 0.5
    out = torch.randn(1 << 16, generator=g) * 8.0  # outlier channel
    return [gauss, lap, t4, torch.cat([gauss[: 1 << 16], out])]


def default_universal_codebooks(cfg: BCQConfig | None = None,
                                regenerate: bool = False) -> CodebookSet:
    """The frozen universal codebooks for ``cfg`` (default: the paper's
    g64 / L_b 8 / N_c 8), read from ``_CB_DIR``; fitted from the synthetic
    mixture and written there when ``regenerate`` is set.  Unlike the
    reference, a missing file raises FileNotFoundError instead of being
    fitted and written into the package on the fly."""
    cfg = cfg or BCQConfig()
    path = _cache_path(cfg)
    if not regenerate:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no universal codebooks for {cfg.tag()} at {path}; fit them with "
                "default_universal_codebooks(cfg, regenerate=True) or save_as_default")
        return CodebookSet.load(path)
    os.makedirs(_CB_DIR, exist_ok=True)
    cbs = calibrate_universal(_mixture_samples(), cfg)
    cbs.save(path)
    return cbs


def save_as_default(cbs: CodebookSet) -> str:
    os.makedirs(_CB_DIR, exist_ok=True)
    path = _cache_path(cbs.cfg)
    cbs.save(path)
    return path


def capture_gemm_inputs(params, tokens, cfg, rt, max_per_layer: int = 4096) -> list:
    """Run a dense forward of ``tokens`` (B, S) and keep the first
    ``max_per_layer`` scalars of every GEMM input (paper §4.1: one batch
    of activations): the embedding output, then per layer the ln1 output
    of its input and the ln2 output of its output, as the reference."""
    from repro_torch.models import layers as L, transformer as T

    b, s = tokens.shape
    x = T.embed_tokens(params, tokens, rt)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    cb = params.get("codebooks")
    samples = [x.reshape(-1)[:max_per_layer]]
    h = x
    for i in range(cfg.n_layers):
        p_i = T._layer(params["layers"], i)
        samples.append(L.norm_apply(h, p_i["ln1"], cfg.norm).reshape(-1)[:max_per_layer])
        h, _ = T.block_apply(h, p_i, cfg, rt, cb, positions, None)
        samples.append(L.norm_apply(h, p_i["ln2"], cfg.norm).reshape(-1)[:max_per_layer])
    return samples


def stacked_kernels(tree) -> list:
    """The leaves of ndim ≥ 3 (the layer-stacked kernels) of a tree, in
    ``jax.tree.leaves``' order: dict keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in stacked_kernels(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) and tree.ndim >= 3 else []


def calibrate_from_model(params, tokens, cfg, rt, bcq_cfg: BCQConfig | None = None,
                         include_weights: bool = True, **fit_kw) -> CodebookSet:
    """Paper §3 calibration: the GEMM inputs of one batch and the first
    65,536 scalars of every layer-stacked kernel → LO-BCQ codebooks."""
    bcq_cfg = bcq_cfg or BCQConfig()
    samples = capture_gemm_inputs(params, tokens, cfg, rt)
    if include_weights:
        samples += [leaf.reshape(-1)[: 1 << 16] for leaf in stacked_kernels(params["layers"])]
    return fit_lobcq(samples, bcq_cfg, **fit_kw)
