"""Training on one device: the train step, checkpoint and restart,
the preemption hook and resume (counterpart of ``repro/launch/train.py``).

CLI (a smoke run on the CPU; drop ``--smoke --device cpu`` for the
full-width model on the card)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt3_126m \\
        --smoke --device cpu --steps 200 --batch 16 --seq 128 --ckpt CKPT_DIR

Rerunning with the same ``--ckpt`` resumes from its latest checkpoint.
The run starts from the reference's training tree (``ModelAPI.init_train``:
float weights, plus the universal codebooks as a trained float leaf under
``--quant fake``), computes in bf16 (f32 for ``--smoke``) on f32
parameters, and saves ``{"params", "opt"}`` through the port's
``CheckpointManager``.  SIGTERM writes a blocking snapshot of the last
finished step and, as the reference's hook, calls the previous handler
only if that is callable: under the default handler the process keeps
running, so a supervisor that preempts it waits for the snapshot and then
ends it.

The step is deterministic, as the reference's XLA step is: a run killed
and resumed ends bit-equal to an uninterrupted one.  The loop runs under
``torch.use_deterministic_algorithms(True)`` (``deterministic``), which
takes the sort-based, atomic-free backward of the embedding gather, the
cross-entropy gather and the codebook gather; cuBLAS needs
``CUBLAS_WORKSPACE_CONFIG`` set before its first call in the process
(``main`` sets it).  The reference's mesh, its compressed data-parallel
step and ``--model-parallel`` > 1 wait for the multi-device item.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.utils.deterministic

from repro_torch.checkpoint import manager as ckpt_lib
from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.data.pipeline import DataConfig, Prefetcher, eval_stream
from repro_torch.models import zoo
from repro_torch.models.layers import Runtime
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import Watchdog

# cuBLAS's deterministic workspace setting (what torch asks for under
# use_deterministic_algorithms)
CUBLAS_WORKSPACE = ":4096:8"
DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def value_and_grad(fn, params, *args):
    """(fn(params, *args), its gradient tree), as ``jax.value_and_grad``:
    every float leaf is differentiated (a leaf the function never reads
    gets zeros, as JAX gives), integer leaves get None.  The loss comes
    back detached."""
    p = adamw.tree_map(lambda t: t.detach().requires_grad_() if t.is_floating_point() else t,
                       params)
    with torch.enable_grad():
        loss = fn(p, *args)
    flat = [t for t in adamw.tree_leaves(p) if t.requires_grad]
    it = iter(torch.autograd.grad(loss, flat, allow_unused=True))

    def grad_of(t):
        if not t.requires_grad:
            return None
        g = next(it)
        return torch.zeros_like(t) if g is None else g

    return loss.detach(), adamw.tree_map(grad_of, p)


def make_train_step(api, opt_cfg: adamw.AdamWConfig):
    """``train_step(params, opt_state, batch)`` → (params, opt_state,
    {"loss", "grad_norm", "lr"}): the loss's gradient, then one AdamW
    update, out of place."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(api.loss_fn, params, batch)
        params, opt_state, metrics = adamw.apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the body, the
    previous setting after it.  Uninitialized memory is not filled: every
    op of the step writes its whole output, and the fill costs a pass over
    each new buffer."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    fill = torch.utils.deterministic.fill_uninitialized_memory
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def run(args):
    """Train, save, evaluate.  Returns (params, the held-out loss)."""
    if args.model_parallel > 1:
        raise SystemExit(
            f"--model-parallel {args.model_parallel}: the port trains on one device; the mesh "
            "is the multi-device item still to port (ROADMAP A13: derive_mesh, launch/mesh.py, "
            "runtime/pipeline.py)")
    device = zoo.resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    rt = Runtime(quant_mode=args.quant,
                 compute_dtype=torch.float32 if args.smoke else torch.bfloat16,
                 param_dtype=torch.float32, remat=args.remat)
    api = zoo.build(cfg, rt, device=device)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps)
    train_step = make_train_step(api, opt_cfg)

    cm = ckpt_lib.CheckpointManager(str(args.ckpt), keep=2)
    restored = cm.restore() if args.resume else None
    if restored is not None:
        start_step, state = restored
        params = zoo._to(state["params"], device)
        opt_state = zoo._to(state["opt"], device)
        opt_state["step"] = opt_state["step"].to(torch.int32).reshape(())
        print(f"resumed from step {start_step}")
    else:
        start_step = 0
        params = api.init_train(args.seed)
        opt_state = adamw.init_state(params)
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))
    print(f"device={device} arch={cfg.name} params≈{n_params / 1e6:.1f}M quant={args.quant} "
          f"remat={args.remat}")

    # preemption: a blocking snapshot of the last finished step on SIGTERM;
    # the step swaps ``latest`` whole, so the snapshot never sees half a step
    latest = [(start_step, params, opt_state)]

    def snapshot():
        step, p, o = latest[0]
        cm.save(step, {"params": p, "opt": o}, blocking=True)

    prev_handler = signal.getsignal(signal.SIGTERM)
    ckpt_lib.install_sigterm_hook(snapshot)
    pf = Prefetcher(dcfg, start_step=start_step, pin=device.type == "cuda")
    try:
        it = iter(pf)
        losses = []
        wd = Watchdog(n_hosts=1)
        tokens_per_step = args.batch * args.seq
        model_flops_step = 6.0 * n_params * tokens_per_step
        t0 = time.time()
        with deterministic():
            for _ in range(start_step, args.steps):
                step, host = next(it)
                batch = {k: v.to(device, non_blocking=True) for k, v in host.items()}
                params, opt_state, metrics = train_step(params, opt_state, batch)
                latest[0] = (step + 1, params, opt_state)
                losses.append(metrics["loss"])
                wd.beat(0, step)
                if (step + 1) % args.log_every == 0:
                    window = torch.stack(losses[-args.log_every:]).cpu().numpy()
                    dt = (time.time() - t0) / args.log_every
                    t0 = time.time()
                    stragglers = wd.stragglers()
                    print(
                        f"step {step + 1} loss {np.mean(window, dtype=np.float64):.4f} "
                        f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e} "
                        f"{dt * 1e3:.0f} ms/step {tokens_per_step / dt:.0f} tok/s "
                        f"flops/step {model_flops_step:.2e}"
                        + (f" STRAGGLERS {stragglers}" if stragglers else ""), flush=True)
                if (step + 1) % args.save_every == 0:
                    cm.save(step + 1, {"params": params, "opt": opt_state})
        pf.close()
        cm.save(args.steps, {"params": params, "opt": opt_state}, blocking=True)
        cm.wait()

        # held-out evaluation
        with torch.no_grad():
            ev = [float(api.loss_fn(params, b)) for b in eval_stream(dcfg, 4, device=device)]
    finally:
        pf.close()
        signal.signal(signal.SIGTERM, prev_handler)
    tail = torch.stack(losses[-20:]).cpu().numpy() if losses else np.array([np.nan])
    print(f"final train loss {np.mean(tail, dtype=np.float64):.4f} eval loss {np.mean(ev):.4f} "
          f"ppl {np.exp(np.mean(ev)):.2f}", flush=True)
    return params, float(np.mean(ev))


def main(argv=None):
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gpt3_126m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default="none", choices=["none", "fake"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
