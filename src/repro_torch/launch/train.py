"""Training over a mesh: the sharded train step, the compressed
data-parallel step, checkpoint and restart, the preemption hook and
resume (counterpart of ``repro/launch/train.py``).

CLI (a smoke run on the CPU; drop ``--smoke --device cpu`` for the
full-width model on the card)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt3_126m \\
        --smoke --device cpu --steps 200 --batch 16 --seq 128 --ckpt CKPT_DIR

Over N ranks of one host (N cards; ``torchrun`` sets the ranks, the
mesh is ``derive_mesh(model_parallel=...)`` over them)::

    PYTHONPATH=src torchrun --standalone --nproc-per-node N \\
        -m repro_torch.launch.train --arch gpt3_126m --model-parallel 2 --ckpt CKPT_DIR

Rerunning with the same ``--ckpt`` resumes from its latest checkpoint.
The run starts from the reference's training tree (``ModelAPI.init_train``:
float weights, plus the universal codebooks as a trained float leaf under
``--quant fake``), computes in bf16 (f32 for ``--smoke``) on f32
parameters, and saves ``{"params", "opt"}`` through the port's
``CheckpointManager``.  SIGTERM asks for a blocking snapshot: the
handler only sets a flag (as the reference's hook, it then calls the
previous handler only if that is callable, so under the default handler
the process keeps running, and a supervisor that preempts it waits for
the snapshot and then ends it).  At each step boundary the ranks agree
on the flag (over several ranks an all-reduce of it, one host sync a
step) and, if any rank got the signal, all of them gather and save the
step just finished in lockstep.  A save inside the handler would run
its gathers wherever that rank stood, against another rank's step.

The step is deterministic, as the reference's XLA step is: a run killed
and resumed ends bit-equal to an uninterrupted one.  The loop runs under
``torch.use_deterministic_algorithms(True)`` (``deterministic``), which
takes the sort-based, atomic-free backward of the embedding gather, the
cross-entropy gather and the codebook gather; cuBLAS needs
``CUBLAS_WORKSPACE_CONFIG`` set before its first call in the process
(``main`` sets it).

The step always runs over the mesh, as the reference's pjit step does
(``make_sharded_train_step``): each rank keeps its shard of every leaf
under ``zoo.param_pspecs`` (AdamW's moments alike), gathers the leaves,
takes the gradient of its batch shard, averages the gradients over the
data axes, takes the global gradient norm and updates its shards.  That
is the reference's math, not its schedule: XLA partitions the matmuls,
this step gathers the weights and computes them whole.  On one device
every axis has size 1, no collective runs and the step is
``make_train_step`` bit for bit.  Checkpoints hold the global trees:
every rank gathers, rank 0 writes.
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
import torch.distributed as dist
import torch.utils.deterministic

from repro_torch.checkpoint import manager as ckpt_lib
from repro_torch.configs.base import get_arch, get_smoke
from repro_torch.data.pipeline import DataConfig, Prefetcher, eval_stream
from repro_torch.models import zoo
from repro_torch.models.layers import Runtime
from repro_torch.optim import adamw
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim.compress import compress_grads_tree, compressed_allreduce_local
from repro_torch.runtime.elastic import Watchdog, derive_mesh

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


def shardings_for(mesh, api, params_shapes):
    """The spec trees of the params and of AdamW's state (the moments laid
    out as the params, the step replicated).  ``api`` is unused: the specs
    follow from the shapes, as in the reference."""
    pspecs = zoo.param_pspecs(params_shapes, mesh_lib.axis_sizes(mesh))
    return pspecs, {"m": pspecs, "v": pspecs, "step": ()}


def shard_tree(tree, specs, mesh):
    """Each leaf's local block under its spec (None leaves stay None)."""
    return mesh_lib.tree_map_specs(
        lambda t, s: None if t is None else mesh_lib.shard(t, mesh, s), tree, specs)


def gather_tree(tree, specs, mesh):
    """Each leaf's global tensor from the ranks' blocks."""
    return mesh_lib.tree_map_specs(
        lambda t, s: None if t is None else mesh_lib.gather(t, mesh, s), tree, specs)


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch (``zoo.batch_pspecs``)."""
    specs = zoo.batch_pspecs(batch, mesh_lib.axis_sizes(mesh))
    return {k: mesh_lib.shard(v, mesh, specs[k]) for k, v in batch.items()}


def make_sharded_train_step(api, opt_cfg: adamw.AdamWConfig, mesh, pspecs):
    """``step(params, opt_state, batch)`` over ``mesh``: params and
    opt_state are this rank's shards under ``pspecs`` (``shardings_for``),
    batch the global batch.  The leaves are all-gathered, the loss and its
    gradient taken on this rank's batch shard, loss and gradients averaged
    over the data axes, the global norm taken of the whole gradients, and
    AdamW applied to the local shards.  Returns (params, opt_state,
    {"loss", "grad_norm", "lr"}), as ``make_train_step``."""
    data = tuple(mesh_lib.axis(mesh, a) for a in mesh_lib.data_axes(mesh))

    def step(params, opt_state, batch):
        full = gather_tree(params, pspecs, mesh)
        loss, grads = value_and_grad(api.loss_fn, full, shard_batch(batch, mesh))
        loss = mesh_lib.pmean(loss, data)
        grads = adamw.tree_map(lambda g: None if g is None else mesh_lib.pmean(g, data), grads)
        gn = adamw.global_norm(grads)
        params, opt_state, metrics = adamw.apply_updates(
            params, shard_tree(grads, pspecs, mesh), opt_state, opt_cfg, grad_norm=gn)
        return params, opt_state, {"loss": loss, **metrics}

    return step


def make_compressed_dp_step(api, opt_cfg: adamw.AdamWConfig, mesh, axis: str = "data"):
    """Pure data parallelism over ``axis`` with the int8 error-feedback
    gradient all-reduce (the cross-pod pattern; any mesh with the axis).
    ``step(params, opt_state, err, batch)`` → (params, opt_state, err,
    {"loss", "grad_norm", "lr"}): params, opt_state and the error buffers
    (``compress.init_error_state``) whole on every rank, the batch global;
    the loss is the mean over the axis, every float gradient leaf goes
    through ``compressed_allreduce_local``."""
    ax = mesh_lib.axis(mesh, axis)

    def step(params, opt_state, err, batch):
        local = {k: mesh_lib.shard(v, mesh, (axis,)) for k, v in batch.items()}
        loss, grads = value_and_grad(api.loss_fn, params, local)
        loss = mesh_lib.pmean(loss, ax)
        grads, err = compress_grads_tree(
            grads, err, lambda g, e: compressed_allreduce_local(g, e, ax))
        params, opt_state, metrics = adamw.apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, err, {"loss": loss, **metrics}

    return step


def preempted(flag: list, device) -> bool:
    """Whether any rank got SIGTERM since the last call (``flag[0]``, set
    by the handler, is cleared here).  Every rank calls it at the same
    step boundary: over several ranks the flags are all-reduced (max), so
    all ranks answer alike; a world of one reads its own flag."""
    hit, flag[0] = flag[0], False
    if dist.get_world_size() == 1:
        return hit
    t = torch.tensor(float(hit), device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


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
    """Train, save, evaluate over the mesh ``derive_mesh(model_parallel=
    args.model_parallel)`` of the process group (``mesh.init_group``: a
    world of one unless ``torchrun`` started this rank).  Returns (the
    global params, the held-out loss)."""
    device = zoo.resolve_device(args.device)
    device = mesh_lib.init_group(device)
    mesh = derive_mesh(model_parallel=args.model_parallel)
    rank0 = torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    rt = Runtime(quant_mode=args.quant,
                 compute_dtype=torch.float32 if args.smoke else torch.bfloat16,
                 param_dtype=torch.float32, remat=args.remat)
    api = zoo.build(cfg, rt, device=device)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps)

    cm = ckpt_lib.CheckpointManager(str(args.ckpt), keep=2)
    restored = cm.restore() if args.resume else None
    if restored is not None:
        start_step, state = restored
        params = zoo._to(state["params"], device)
        opt_state = zoo._to(state["opt"], device)
        opt_state["step"] = opt_state["step"].to(torch.int32).reshape(())
        say(f"resumed from step {start_step}")
    else:
        start_step = 0
        params = api.init_train(args.seed)
        opt_state = None
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))
    pspecs, ospecs = shardings_for(mesh, api, params)
    params = shard_tree(params, pspecs, mesh)
    opt_state = adamw.init_state(params) if opt_state is None else shard_tree(opt_state, ospecs,
                                                                              mesh)
    train_step = make_sharded_train_step(api, opt_cfg, mesh, pspecs)
    say(f"device={device} mesh={mesh_lib.axis_sizes(mesh)} arch={cfg.name} "
        f"params≈{n_params / 1e6:.1f}M quant={args.quant} remat={args.remat}")

    def save(step, p, o, blocking=False):
        tree = {"params": gather_tree(p, pspecs, mesh), "opt": gather_tree(o, ospecs, mesh)}
        if rank0:
            cm.save(step, tree, blocking=blocking)

    # preemption: the handler sets the flag; the loop saves at a step boundary
    sigterm = [False]
    prev_handler = signal.getsignal(signal.SIGTERM)
    ckpt_lib.install_sigterm_hook(lambda: sigterm.__setitem__(0, True))
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
                losses.append(metrics["loss"])
                wd.beat(0, step)
                if (step + 1) % args.log_every == 0:
                    window = torch.stack(losses[-args.log_every:]).cpu().numpy()
                    dt = (time.time() - t0) / args.log_every
                    t0 = time.time()
                    stragglers = wd.stragglers()
                    say(
                        f"step {step + 1} loss {np.mean(window, dtype=np.float64):.4f} "
                        f"gnorm {float(metrics['grad_norm']):.3f} lr {float(metrics['lr']):.2e} "
                        f"{dt * 1e3:.0f} ms/step {tokens_per_step / dt:.0f} tok/s "
                        f"flops/step {model_flops_step:.2e}"
                        + (f" STRAGGLERS {stragglers}" if stragglers else ""), flush=True)
                snap = preempted(sigterm, device)  # every rank, every step
                if snap or (step + 1) % args.save_every == 0:
                    save(step + 1, params, opt_state, blocking=snap)
        pf.close()
        # the writer may still be writing this very step (save_every divides
        # steps): let it land first, or the two writes race on one tmp file
        cm.wait()
        save(args.steps, params, opt_state, blocking=True)
        cm.wait()

        # held-out evaluation
        params = gather_tree(params, pspecs, mesh)
        with torch.no_grad():
            ev = [float(api.loss_fn(params, b)) for b in eval_stream(dcfg, 4, device=device)]
    finally:
        pf.close()
        signal.signal(signal.SIGTERM, prev_handler)
    tail = torch.stack(losses[-20:]).cpu().numpy() if losses else np.array([np.nan])
    say(f"final train loss {np.mean(tail, dtype=np.float64):.4f} eval loss {np.mean(ev):.4f} "
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
