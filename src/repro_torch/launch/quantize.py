"""Offline PTQ CLI: checkpoint → LO-BCQ artifacts (the paper's deploy step),
counterpart of ``repro/launch/quantize.py``.

Restores a checkpoint (``checkpoint.manager``; its ``params`` tree),
calibrates universal codebooks on one batch of a dense model's GEMM
inputs and its weights (other families take the committed books), and
writes, with the reference's names and formats:

- ``codebooks.json`` — the fitted codebooks (``CodebookSet.save``);
- ``weights_w4_fake.npz`` — the GEMM weights snapped to the LO-BCQ grid
  (``ptq.quantize_params``) plus ``codebooks``: a ``quant_mode="fake"``
  serving tree;
- ``weights_w4_packed.npz`` — each GEMM weight's packed 4-bit buffers
  (``ptq.encode_params``; ``ptq.packed_from_artifact`` turns them into a
  ``quant_mode="packed"`` tree);
- ``manifest.json`` — the bit accounting of Eq. 9.

Runs on the card unless ``--device cpu`` is given, at any
``--array-len`` / ``--n-codebooks`` the kernels take
(``bcq.check_kernel_config`` refuses the rest before the checkpoint is
read)::

    PYTHONPATH=src python -m repro_torch.launch.quantize --ckpt CKPT_DIR \\
        --out OUT_DIR [--arch gpt3_126m] [--smoke --device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.checkpoint import manager as ckpt_lib
from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.core import ptq
from repro_torch.core.bcq import BCQConfig, check_kernel_config
from repro_torch.core.calibrate import calibrate_from_model, default_universal_codebooks
from repro_torch.models.layers import Runtime
from repro_torch.models.zoo import _to, resolve_device

CALIB_STEP = 999_999  # the calibration batch: batch_at(4 × 128 tokens, this step)


def quantize_checkpoint(params, cfg, bcq_cfg: BCQConfig, out_dir: str, calib_tokens=None,
                        write_packed: bool = True) -> dict:
    """Calibrate (dense family with ``calib_tokens``: 15 LO-BCQ iterations
    on the card the params live on; else the committed books) and write
    the artifacts.  Returns the manifest."""
    rt = Runtime(quant_mode="none", compute_dtype=torch.float32, param_dtype=torch.float32)
    if calib_tokens is not None and cfg.family == "dense":
        cbs = calibrate_from_model(params, calib_tokens, cfg, rt, bcq_cfg, iters=15)
    else:
        cbs = default_universal_codebooks(bcq_cfg)
    cb = cbs.as_tensor(params["embed"]["kernel"].device)

    os.makedirs(out_dir, exist_ok=True)
    cbs.save(os.path.join(out_dir, "codebooks.json"))

    pq = ptq.quantize_params(params, cb, bcq_cfg)
    pq["codebooks"] = cb
    ckpt_lib.save_pytree(os.path.join(out_dir, "weights_w4_fake.npz"), pq)

    packed_paths = {}
    if write_packed:
        packed = {
            path.strip("/").replace("/", "."): {
                "idx": e.packed_idx, "sel": e.packed_sel, "scale": e.scale_code, "s_x": e.s_x,
            }
            for path, (e, _) in ptq.encode_params(params, cb, bcq_cfg).items()
        }
        ckpt_lib.save_pytree(os.path.join(out_dir, "weights_w4_packed.npz"), packed)
        packed_paths = {k: list(v["idx"].shape) for k, v in packed.items()}

    stats = ptq.count_quantized_bits(params, bcq_cfg)
    manifest = {
        "arch": cfg.name,
        "bcq": {"L_b": bcq_cfg.block_len, "L_A": bcq_cfg.array_len,
                "N_c": bcq_cfg.n_codebooks, "bits": bcq_cfg.bitwidth()},
        "codebook_bytes": cbs.nbytes(),
        "params": stats["params"],
        "gemm_params": stats["gemm_params"],
        "compression_vs_bf16": stats["compression"],
        "packed_tensors": packed_paths,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--arch", default="gpt3_126m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", required=True)
    ap.add_argument("--array-len", type=int, default=64)
    ap.add_argument("--n-codebooks", type=int, default=8)
    ap.add_argument("--no-packed", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bcq_cfg = BCQConfig(array_len=args.array_len, n_codebooks=args.n_codebooks)
    if torch.device(args.device).type == "cuda":
        check_kernel_config(bcq_cfg, "repro_torch.launch.quantize on the card")
    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    restored = ckpt_lib.CheckpointManager(args.ckpt).restore()
    if restored is None:
        raise SystemExit(f"no checkpoint under {args.ckpt}")
    _, state = restored
    params = _to(state["params"], device)

    from repro_torch.data.pipeline import DataConfig, batch_at

    calib = batch_at(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=4), CALIB_STEP,
                     device=device)["tokens"]
    m = quantize_checkpoint(params, cfg, bcq_cfg, args.out, calib, not args.no_packed)
    print(json.dumps({k: v for k, v in m.items() if k != "packed_tensors"}, indent=1))
    print(f"artifacts in {args.out}: codebooks.json, weights_w4_fake.npz"
          + ("" if args.no_packed else ", weights_w4_packed.npz") + ", manifest.json")
    return m


if __name__ == "__main__":
    main()
