"""The paper's full pipeline at container scale on the PyTorch/CUDA port
(Table 2 analogue):

1. train a GPT3-126M-family model (reduced width) on the synthetic corpus,
2. calibrate universal LO-BCQ codebooks on ONE batch of its activations +
   weights (paper §4.1: GPT3-126M/Wikitext-103 calibration),
3. freeze the codebooks, PTQ the weights (no weight updates),
4. evaluate held-out perplexity: BF16 vs W4A4 LO-BCQ vs MX4 / MXFP4 / VSQ /
   INT4 at matched bitwidth.

Expected (paper's qualitative claim): ΔPPL(LO-BCQ) « ΔPPL(MX4/MXFP4/VSQ).
Runs on the card unless ``--device cpu`` is given::

  PYTHONPATH=src python examples/torch_calibrate_and_eval.py --steps 300 [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_smoke
from repro_torch.core import baselines, ptq
from repro_torch.core.bcq import BCQConfig
from repro_torch.core.calibrate import calibrate_from_model
from repro_torch.data.pipeline import DataConfig, batch_at, eval_stream
from repro_torch.launch.train import make_train_step
from repro_torch.models import zoo
from repro_torch.models.layers import Runtime
from repro_torch.optim import adamw


def eval_ppl(api, params, dcfg, device, n=4):
    with torch.no_grad():
        losses = [float(api.loss_fn(params, b)) for b in eval_stream(dcfg, n, device=device)]
    return float(np.exp(np.mean(losses)))


def quantize_with(params, fn):
    """Apply a baseline fake-quant fn to every GEMM weight (blocks along K)."""

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if ptq._is_gemm_weight(path, tree):
            return fn(tree.transpose(-1, -2)).transpose(-1, -2).to(tree.dtype)
        return tree

    return walk(params)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = zoo.resolve_device(args.device)

    cfg = get_smoke("gpt3_126m")
    rt = Runtime(quant_mode="none", compute_dtype=torch.float32, param_dtype=torch.float32)
    api = zoo.build(cfg, rt, device=device)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    # ---- 1. train ------------------------------------------------------
    params = api.init(0)
    opt = adamw.init_state(params)
    ocfg = adamw.AdamWConfig(lr=2e-3, warmup_steps=30, total_steps=args.steps)
    step_fn = make_train_step(api, ocfg)
    for s in range(args.steps):
        params, opt, m = step_fn(params, opt, batch_at(dcfg, s, device=device))
        if (s + 1) % 100 == 0:
            print(f"train step {s+1}: loss {float(m['loss']):.4f}")

    ppl_float = eval_ppl(api, params, dcfg, device)
    print(f"\nBF16 baseline PPL: {ppl_float:.3f}")

    # ---- 2. calibrate universal codebooks on ONE batch ------------------
    bcq_cfg = BCQConfig(block_len=8, array_len=64, n_codebooks=8)  # 4.5 b
    calib_tokens = batch_at(dcfg, 999_999, device=device)["tokens"][:4]
    with torch.no_grad():
        cbs = calibrate_from_model(params, calib_tokens, cfg, rt, bcq_cfg, iters=15)
    cb = cbs.as_tensor(device)
    print(f"calibrated {bcq_cfg.n_codebooks} codebooks "
          f"({cbs.nbytes():.0f} B, frozen from here on)")

    # ---- 3+4. PTQ with each scheme and evaluate --------------------------
    rt_q = Runtime(quant_mode="fake", bcq_cfg=bcq_cfg,
                   compute_dtype=torch.float32, param_dtype=torch.float32)
    api_q = zoo.build(cfg, rt_q, device=device)

    rows = [("BF16 (pretrained)", 16.0, ppl_float)]

    with torch.no_grad():
        pq = ptq.quantize_params(params, cb, bcq_cfg)
    pq["codebooks"] = cb
    rows.append((f"LO-BCQ W4A4 ({bcq_cfg.tag()})", bcq_cfg.bitwidth(),
                 eval_ppl(api_q, pq, dcfg, device)))

    # baselines: honest W4A4 — weights PTQ'd with each scheme's grid AND
    # activations quantized on the fly with the same scheme (act_format)
    act_fmt = {"MX4_g16": "mx4", "MXFP4_g32": "mxfp4", "VSQ_g16": "vsq", "INT4_pt": "int4"}
    for name, (fn, bits) in baselines.BASELINES.items():
        if name not in act_fmt:
            continue
        with torch.no_grad():
            pw = quantize_with(params, fn)
        pw["codebooks"] = cb  # unused by non-bcq act formats, keeps API uniform
        rt_b = Runtime(quant_mode="fake", bcq_cfg=bcq_cfg, act_format=act_fmt[name],
                       compute_dtype=torch.float32, param_dtype=torch.float32)
        api_b = zoo.build(cfg, rt_b, device=device)
        rows.append((f"{name} (W4A4)", bits, eval_ppl(api_b, pw, dcfg, device)))

    print(f"\n{'scheme':32s} {'bits':>6s} {'PPL':>8s} {'ΔPPL':>8s}")
    for name, bits, ppl in rows:
        print(f"{name:32s} {bits:6.2f} {ppl:8.3f} {ppl-ppl_float:8.3f}")
    return {"rows": rows, "codebooks": cbs}


if __name__ == "__main__":
    main()
