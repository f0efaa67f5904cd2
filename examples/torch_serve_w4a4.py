"""End-to-end W4A4 serving example on the PyTorch/CUDA port (the paper's
deployment kind):

train a small model briefly → calibrate + freeze universal codebooks →
PTQ → serve batched requests with on-the-fly activation quantization,
comparing greedy outputs and reporting cache-quantization variants.
Runs on the card unless ``--device cpu`` is given::

  PYTHONPATH=src python examples/torch_serve_w4a4.py --steps 200 --batch 4 --gen 24 [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.base import get_smoke
from repro_torch.core import ptq
from repro_torch.core.bcq import BCQConfig
from repro_torch.core.calibrate import calibrate_from_model
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch.train import make_train_step
from repro_torch.models import zoo
from repro_torch.models.layers import Runtime
from repro_torch.optim import adamw
from repro_torch.serving.generate import greedy_generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = zoo.resolve_device(args.device)

    cfg = get_smoke("gpt3_126m")
    rt = Runtime(quant_mode="none", compute_dtype=torch.float32, param_dtype=torch.float32)
    api = zoo.build(cfg, rt, device=device)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=16)

    print(f"training {cfg.name} for {args.steps} steps ...")
    params = api.init(0)
    opt = adamw.init_state(params)
    step = make_train_step(api, adamw.AdamWConfig(lr=2e-3, warmup_steps=30,
                                                  total_steps=args.steps))
    m = {"loss": float("nan")}
    for s in range(args.steps):
        params, opt, m = step(params, opt, batch_at(dcfg, s, device=device))
    print(f"final train loss {float(m['loss']):.3f}")

    bcq_cfg = BCQConfig()
    with torch.no_grad():
        cbs = calibrate_from_model(params, batch_at(dcfg, 10**6, device=device)["tokens"][:4],
                                   cfg, rt, bcq_cfg, iters=12)
        cb = cbs.as_tensor(device)
        pq = ptq.quantize_params(params, cb, bcq_cfg)
    pq["codebooks"] = cb
    stats = ptq.count_quantized_bits(params, bcq_cfg)
    print(f"PTQ done: {stats['compression']:.2f}× weight compression, codebooks "
          f"{cbs.nbytes():.0f} B frozen")

    prompts = batch_at(DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                                  global_batch=args.batch), 2_000_000, device="cpu")["tokens"]
    max_len = args.prompt_len + args.gen + 1
    with torch.no_grad():
        ref = greedy_generate(api, params, prompts, args.gen, max_len, device=device)

    agree = {}
    for cache in ("bf16", "int8", "bcq4"):
        api_q = zoo.build(cfg, Runtime(quant_mode="fake", bcq_cfg=bcq_cfg, cache_kind=cache,
                                       compute_dtype=torch.float32, param_dtype=torch.float32),
                          device=device)
        with torch.no_grad():
            got = greedy_generate(api_q, pq, prompts, args.gen, max_len, device=device)
        agree[cache] = float((ref == got).float().mean())
        print(f"W4A4 serve (cache={cache:5s}): greedy agreement vs bf16 = "
              f"{agree[cache]*100:5.1f}%")
    print("sample bf16:", ref[0][:12].cpu().numpy())
    print("sample w4a4:", got[0][:12].cpu().numpy())
    return {"agreement": agree, "ref": ref, "w4a4": got}


if __name__ == "__main__":
    main()
