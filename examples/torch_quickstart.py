"""Quickstart on the PyTorch/CUDA port: LO-BCQ in five minutes.

1. Fit LO-BCQ codebooks on a heavy-tailed operand (k-means++ init +
   alternating block-clustering / Lloyd-Max — paper §2.2).
2. Show the non-increasing MSE trajectory (§A.2 invariant).
3. Encode → packed 4.5-bit buffers → decode; compare NMSE against the
   MX4 / MXFP4 / VSQ baselines at matched bitwidth (Fig. 4/9 analogue).
4. Run the W4A4 kernels — the two-launch GEMM (quantize, then the packed
   GEMM) and the fused linear — against the fake-quant reference.

Runs on the card unless ``--device cpu`` is given (where the kernels'
plain versions run)::

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import baselines, bcq
from repro_torch.core.bcq import BCQConfig, fit_lobcq
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fused_linear_ref, matmul_ref
from repro_torch.models.zoo import resolve_device

X_SHAPE = (512, 1024)  # the operand
W_ROWS, GEMM_ROWS = 256, 64  # the GEMM's weight rows and activation rows
FIT_ITERS = 20


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = torch.Generator().manual_seed(0)
    # LLM-activation-like operand: gaussian bulk + rare large outliers
    x = torch.randn(X_SHAPE, generator=g)
    mask = torch.rand(x.shape, generator=g) < 0.005
    x = torch.where(mask, x * 20.0, x).to(device)

    cfg = BCQConfig(block_len=8, array_len=64, n_codebooks=8)  # 4.5 bits
    print(f"config {cfg.tag()}  bitwidth {cfg.bitwidth():.4f} bits/scalar")

    cbs = fit_lobcq(x, cfg, iters=FIT_ITERS)
    print("MSE trajectory (non-increasing):",
          " ".join(f"{h:.4f}" for h in cbs.history[:8]), "...")
    assert all(b <= a + 1e-9 for a, b in zip(cbs.history, cbs.history[1:]))
    print(f"codebooks: {cfg.n_codebooks}×{cfg.n_entries} INT6 entries "
          f"({cbs.nbytes():.0f} bytes total — fits in any cache)")

    cb = cbs.as_tensor(device)
    xq = bcq.fake_quant(x, cb, cfg)
    nmse = {"LO-BCQ": float(bcq.quantization_nmse(x, xq))}
    print(f"\nNMSE  LO-BCQ(4.5b)  : {nmse['LO-BCQ']:.5f}")
    for name, (fn, bits) in baselines.BASELINES.items():
        nmse[name] = float(bcq.quantization_nmse(x, fn(x)))
        print(f"NMSE  {name:14s}({bits}b): {nmse[name]:.5f}")

    # packed W4A4 GEMM through the kernels (their plain versions on the CPU)
    w = torch.randn((W_ROWS, X_SHAPE[1]), generator=g).to(device)
    xa = x[:GEMM_ROWS].contiguous()
    pa = ops.quantize(xa, cb, cfg)
    pw = ops.quantize(w, cb, cfg)
    out = ops.matmul(pa, pw, cb, cfg)
    fused = ops.w4a4_linear_fused(xa, pw, cb, cfg)
    ref = bcq.fake_quant(xa, cb, cfg) @ bcq.fake_quant(w, cb, cfg).T
    plain = matmul_ref(pa.idx_packed, pa.sel_packed, pa.inv_scale, pw.idx_packed,
                       pw.sel_packed, pw.inv_scale, cb, cb, cfg)
    fused_plain = fused_linear_ref(xa, pw.idx_packed, pw.sel_packed, pw.inv_scale, cb, cfg,
                                   bcq.tensor_scale(xa, cfg), valid_k=xa.shape[1])
    err = float((out - ref).abs().max())
    print(f"\nW4A4 GEMM (quantize + packed GEMM) vs fake-quant reference: max |Δ| = {err:.2e}")
    print(f"fused W4A4 linear vs the two-launch GEMM: max |Δ| = "
          f"{float((fused - out).abs().max()):.2e}")
    storage = (pw.idx_packed.numel() + pw.sel_packed.numel()
               + 4 * pw.inv_scale.numel()) / w.numel()
    print(f"packed weight storage: {storage*8:.2f} bits/scalar (incl. f32 staging scales)")
    return {"nmse": nmse, "history": cbs.history, "gemm": out, "fused": fused,
            "gemm_plain": plain, "fused_plain": fused_plain, "fake_quant": ref}


if __name__ == "__main__":
    main()
