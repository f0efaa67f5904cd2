"""The port's side of ``tests/test_torch_distributed.py``: the body each
gloo rank runs (``torch.multiprocessing.spawn``).  It imports only torch
and the port, so the ranks start fast; the inputs come from the test's
``inputs.npz`` (the same numpy the JAX side reads), and each rank writes
what it computed to ``rank<r>.npz`` for the test to compare."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

N_COMPRESS_STEPS = 10
N_SHARDED_STEPS = 8
LR = 1e-3


def unflatten(npz, prefix: str) -> dict:
    """The nested dict of tensors saved under ``prefix/…`` keys."""
    out: dict = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(npz[key]))
    return out


def flatten(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flatten(v, f"{prefix}/{k}").items()}
    return {prefix: tree.detach().numpy()}


def _compress(rank, inp, out, mesh_lib):
    from repro_torch.optim.compress import compressed_allreduce_local

    mesh = mesh_lib.make_mesh((8,), ("data",))
    mean, err = compressed_allreduce_local(torch.from_numpy(inp["compress/g"][rank]),
                                           torch.from_numpy(inp["compress/err"][rank]),
                                           mesh_lib.axis(mesh, "data"))
    out["compress/mean"], out["compress/err"] = mean.numpy(), err.numpy()


def _gpt3(inp):
    from repro_torch.configs.base import get_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    cfg = get_smoke("gpt3_126m")
    api = zoo.build(cfg, Runtime(quant_mode="none", compute_dtype=torch.float32,
                                 param_dtype=torch.float32), device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    return api, dcfg, unflatten(inp, "gpt3")


def _compressed_dp(rank, inp, out, mesh_lib):
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch.train import make_compressed_dp_step
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import init_error_state

    api, dcfg, params = _gpt3(inp)
    mesh = mesh_lib.make_mesh((8,), ("data",))
    step = make_compressed_dp_step(api, adamw.AdamWConfig(lr=LR), mesh)
    opt, err = adamw.init_state(params), init_error_state(params)
    losses = []
    for s in range(N_COMPRESS_STEPS):
        params, opt, err, m = step(params, opt, err, batch_at(dcfg, s, device="cpu"))
        losses.append(float(m["loss"]))
    out["cdp/losses"] = np.array(losses)


def _sharded(rank, inp, out, mesh_lib):
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    api, dcfg, params = _gpt3(inp)
    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"))
    pspecs, _ = train.shardings_for(mesh, api, params)
    local = train.shard_tree(params, pspecs, mesh)
    opt = adamw.init_state(local)
    step = train.make_sharded_train_step(api, adamw.AdamWConfig(lr=LR), mesh, pspecs)
    mesh_lib.reset_collective_bytes()
    losses, norms = [], []
    for s in range(N_SHARDED_STEPS):
        local, opt, m = step(local, opt, batch_at(dcfg, s, device="cpu"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    coll = mesh_lib.collective_bytes()
    out["sharded/losses"], out["sharded/norms"] = np.array(losses), np.array(norms)
    out["sharded/local_numel"] = np.array(sum(t.numel() for t in adamw.tree_leaves(local)))
    out["sharded/coll_kinds"] = np.array(sorted({k for k, _ in coll}))
    out.update(flatten(train.gather_tree(local, pspecs, mesh), "sharded/params"))
    if rank == 0:  # the port's single-device step from the same weights
        single = train.make_train_step(api, adamw.AdamWConfig(lr=LR))
        p, o = params, adamw.init_state(params)
        losses, norms = [], []
        for s in range(N_SHARDED_STEPS):
            p, o, m = single(p, o, batch_at(dcfg, s, device="cpu"))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out["single/losses"], out["single/norms"] = np.array(losses), np.array(norms)
        out.update(flatten(p, "single/params"))


def _pipeline(rank, inp, out, mesh_lib):
    from repro_torch.runtime.pipeline import pipeline_apply

    mesh = mesh_lib.make_mesh((4, 2), ("pod", "model"))

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"])

    w = torch.from_numpy(inp["pipe/w"])
    x = torch.from_numpy(inp["pipe/x"])
    y = pipeline_apply(stage_fn, {"w": mesh_lib.shard(w, mesh, ("pod",))}, x, mesh, "pod",
                       n_micro=8)
    out["pipe/y"] = y.numpy()
    # gradients: each rank's stage against the sequential stages
    w2 = torch.from_numpy(inp["pipe/w2"])
    x2 = torch.from_numpy(inp["pipe/x2"])
    mine = mesh_lib.shard(w2, mesh, ("pod",)).clone().requires_grad_()
    y2 = pipeline_apply(stage_fn, {"w": mine}, x2, mesh, "pod", n_micro=4)
    (y2 ** 2).sum().backward()
    out["pipe/grad"] = mine.grad[0].numpy()


def _decode(rank, inp, out, mesh_lib):
    import dataclasses

    from repro_torch.configs.base import get_smoke
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime

    cfg = get_smoke("qwen1_5_32b")
    rt0 = Runtime(quant_mode="none", compute_dtype=torch.float32, param_dtype=torch.float32)
    mesh = mesh_lib.make_mesh((2, 4), ("data", "model"))
    rt1 = dataclasses.replace(rt0, flash_decode=True, mesh=mesh)
    api0, api1 = zoo.build(cfg, rt0, device="cpu"), zoo.build(cfg, rt1, device="cpu")
    params = unflatten(inp, "qwen")
    toks = torch.from_numpy(inp["decode/tokens"]).long()
    with torch.no_grad():
        _, c0 = api0.prefill_fn(params, {"tokens": toks}, 24)
        local = {n: mesh_lib.shard(t, mesh, (None, "data", "model")) if t.ndim >= 3 else t
                 for n, t in c0.items()}
        local = {n: t.clone() for n, t in local.items()}
        r0, _ = api0.decode_fn(params, c0, toks[:, :1], 16)
        rows = mesh_lib.shard(toks[:, :1], mesh, ("data",))
        mesh_lib.reset_collective_bytes()
        r1, _ = api1.decode_fn(params, local, rows, 16)
    out["decode/gathered"], out["decode/sharded"] = r0.numpy(), r1.numpy()
    out["decode/coll_kinds"] = np.array(sorted({k for k, _ in mesh_lib.collective_bytes()}))


def _collectives(rank, inp, out, mesh_lib):
    """``all_gather`` over ('data', 'model') of the (4, 2) mesh and its
    gradient (a reduce-scatter of every rank's cotangent), and
    ``reduce_scatter`` over the same axes."""
    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"))
    axes = (mesh_lib.axis(mesh, "data"), mesh_lib.axis(mesh, "model"))
    x = torch.from_numpy(inp["coll/x"][rank]).clone().requires_grad_()
    w = torch.from_numpy(inp["coll/w"][rank])
    mesh_lib.reset_collective_bytes()
    full = mesh_lib.all_gather(x, axes, dim=0)
    (full * w).sum().backward()
    out["coll/gathered"], out["coll/grad"] = full.detach().numpy(), x.grad.numpy()
    out["coll/scattered"] = mesh_lib.reduce_scatter(w, axes, dim=0).numpy()
    out["coll/kinds"] = np.array(sorted({k for k, _ in mesh_lib.collective_bytes()}))


def _derive(rank, inp, out, mesh_lib):
    from repro_torch.runtime.elastic import derive_mesh

    sizes = []
    for n in range(1, 9):
        m = derive_mesh(n_devices=n, model_parallel=4)
        sizes.append([m.mesh.numel()] + list(mesh_lib.axis_sizes(m).values()))
    m8 = derive_mesh(model_parallel=4)
    out["derive/sizes"] = np.array(sizes)
    out["derive/world"] = np.array(list(mesh_lib.axis_sizes(m8).values()))


def run(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib

    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", rank=rank, world_size=world, store=store)
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    out: dict = {}
    try:
        for part in (_compress, _compressed_dp, _sharded, _pipeline, _decode, _collectives,
                     _derive):
            part(rank, inp, out, mesh_lib)
    finally:
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()


PREEMPT_STEPS, PREEMPT_IN = 6, 3  # rank 1 gets SIGTERM inside step 3 of 6


def preempt(rank: int, world: int, workdir: str) -> None:
    """The train CLI's ``run`` over a (2, 1) mesh of gloo ranks (the gpt3
    smoke model): a run whose rank 1 sends itself SIGTERM in the middle of
    step ``PREEMPT_IN`` (before the step's gathers and all-reduces), an
    uninterrupted run, and the preempted run resumed from its snapshot
    alone.  The checkpoints land under ``workdir`` for the test."""
    import datetime
    import shutil
    import signal

    from repro_torch.launch import train

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    # a collective that pairs wrongly fails within the minute, not at gloo's default half hour
    dist.init_process_group("gloo", rank=rank, world_size=world, store=store,
                            timeout=datetime.timedelta(seconds=60))

    def args(ckpt):
        return ["--arch", "gpt3_126m", "--smoke", "--device", "cpu", "--batch", "4", "--seq",
                "32", "--steps", str(PREEMPT_STEPS), "--warmup", "2", "--log-every", "100",
                "--ckpt", os.path.join(workdir, ckpt)]

    value_and_grad, calls = train.value_and_grad, [0]

    def signalled(fn, params, *a):
        calls[0] += 1
        if rank == 1 and calls[0] == PREEMPT_IN:
            os.kill(os.getpid(), signal.SIGTERM)
        return value_and_grad(fn, params, *a)

    try:
        train.value_and_grad = signalled
        train.main(args("killed"))
        train.value_and_grad = value_and_grad
        train.main(args("straight"))
        if rank == 0:  # the snapshot alone, without the preempted run's final checkpoint
            os.makedirs(os.path.join(workdir, "resumed"))
            for suffix in ("", ".json"):
                name = f"step_{PREEMPT_IN:08d}.npz{suffix}"
                shutil.copy(os.path.join(workdir, "killed", name),
                            os.path.join(workdir, "resumed", name))
        dist.barrier()
        train.main(args("resumed"))
    finally:
        dist.destroy_process_group()
