"""Multi-pod dry-run on an H100 model: trace every (arch × shape × mesh)
cell on meta tensors (counterpart of ``repro/launch/dryrun.py``).

A fake process group of 256 ranks (512 with ``--mesh multi`` or
``both``) backs the production meshes in one process — (16, 16)
single-pod and (2, 16, 16) multi-pod — and this process plays rank 0.
Per cell:

  1. meta stand-ins for params (``zoo.param_shapes``), optimizer state,
     batch (``zoo.input_specs``) and caches (``zoo.cache_specs``), cut to
     rank 0's blocks by the zoo's sharding rules (no allocation anywhere);
  2. the real sharded train step (``launch.train.make_sharded_train_step``),
     prefill or decode (with ``--flash-decode`` the sequence-sharded one)
     runs on them under ``roofline.trace``: the aten ops' FLOPs and bytes,
     the hand-written kernels' meta counts, the collectives' bytes, the
     peak of live bytes;
  3. the record: the three-term roofline at the H100's data-sheet peaks,
     ``params_gib_per_dev`` / ``cache_gib_per_dev`` and the textbook decode
     memory time at the H100's HBM bandwidth, the peak device memory and
     whether it fits 80 GB.

XLA's compile-time failures have two counterparts here: a spec that its
axes do not divide (``mesh.ShardingError``) and a meta shape mismatch;
either one makes the cell ``"status": "FAIL"``.  Meta execution unrolls
nothing and undercounts no loop body, so ``--no-unroll`` changes nothing
(accepted for the reference's command lines).  ``--attn-chunk`` (1024,
the reference's default) and ``--attn-bf16`` set ``Runtime.attn_chunk``
and ``Runtime.attn_f32`` as the reference's dry-run does: the trace
prices the masked-softmax attention a query chunk at a time (a smaller
chunk, a lower peak) and, with ``--attn-bf16``, its scores in bf16 (half
the score bytes).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out results/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, cell_is_applicable, get_arch
from repro_torch.launch import mesh as mesh_lib, roofline, train
from repro_torch.models import zoo
from repro_torch.models.layers import Runtime
from repro_torch.optim import adamw


def init_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks in this process (rank
    0): meshes of that many ranks, no communication.  One already up and
    as large is kept."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world_size:
            raise RuntimeError(f"a {dist.get_backend()} process group of "
                               f"{dist.get_world_size()} ranks is up: the dry-run needs a "
                               f"fake one of {world_size}")
        return
    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())


def make_runtime(kind: str, args, mesh) -> Runtime:
    if kind == "train":
        return Runtime(quant_mode=args.train_quant, compute_dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16, remat=not args.no_remat,
                       remat_policy=args.remat_policy, logit_chunk=args.logit_chunk,
                       attn_chunk=args.attn_chunk, attn_f32=not args.attn_bf16)
    return Runtime(quant_mode=args.quant, compute_dtype=torch.bfloat16,
                   param_dtype=torch.bfloat16, cache_kind=args.cache,
                   attn_chunk=args.attn_chunk, logit_chunk=args.logit_chunk,
                   flash_decode=args.flash_decode, attn_f32=not args.attn_bf16,
                   mesh=mesh if args.flash_decode and kind == "decode" else None)


def _bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_bytes(v) for v in tree)
    return 0 if tree is None else tree.numel() * tree.element_size()


def _local(tree, specs, axes):
    """Rank 0's blocks of a meta tree; a spec its axes do not divide raises
    ``mesh.ShardingError``."""
    return mesh_lib.tree_map_specs(
        lambda t, s: torch.empty(mesh_lib.local_shape(t.shape, s, axes), dtype=t.dtype,
                                 device="meta"), tree, specs)


def _rows_local(leaf, spec, mesh, batch):
    """A cache leaf (global, meta) as the decode reads it on this rank:
    this rank's block under ``spec``, then its rows (the first dim of size
    ``batch``) over the data axes and every other dim whole — gathered
    where ``spec`` shards it, cut where the rows are not laid out by the
    data axes."""
    axes = mesh_lib.axis_sizes(mesh)
    t = _local(leaf, spec, axes)
    rows = zoo._batch_dim_spec(batch, axes)
    bdim = next((i for i, n in enumerate(leaf.shape) if n == batch), None)
    spec = tuple(spec) + (None,) * (t.ndim - len(spec))
    keep = bdim is not None and spec[bdim] == rows
    t = mesh_lib.gather(t, mesh, tuple(None if keep and i == bdim else e
                                       for i, e in enumerate(spec)))
    if bdim is not None and not keep:
        t = mesh_lib.shard(t, mesh, tuple(rows if i == bdim else None for i in range(t.ndim)))
    return t


def _seq_sharded(tree, specs):
    """The sequence-sharded decode's layout of the self-attention caches:
    every (L, B, S, ...) leaf's sequence over 'model', its rows as the zoo
    lays them."""
    return mesh_lib.tree_map_specs(lambda leaf, spec: spec if leaf.ndim < 3 else
                 (None, spec[1] if len(spec) > 1 else None, "model"), tree, specs)


def trace_cell(cfg, shape, mesh, rt: Runtime):
    """Run one cell's step on rank 0's meta blocks under ``roofline.trace``.
    Returns (the trace, resident bytes per device, global param bytes,
    global cache bytes)."""
    axes = mesh_lib.axis_sizes(mesh)
    api = zoo.build(cfg, rt, device="meta")
    params = zoo.param_shapes(cfg, rt)
    pspecs = zoo.param_pspecs(params, axes)
    local = _local(params, pspecs, axes)
    inputs = zoo.input_specs(cfg, rt, shape)
    bspecs = zoo.batch_pspecs(inputs, axes)
    local_in = _local(inputs, bspecs, axes)
    resident = _bytes(local) + _bytes(local_in)
    c_bytes = 0
    if shape.kind == "train":
        opt = adamw.init_state(local)
        resident += _bytes(opt)
        step = train.make_sharded_train_step(api, adamw.AdamWConfig(), mesh, pspecs)
        with roofline.trace() as tr:
            step(local, opt, inputs)
    elif shape.kind == "prefill":
        with roofline.trace() as tr, torch.no_grad():
            full = train.gather_tree(local, pspecs, mesh)
            api.prefill_fn(full, train.shard_batch(inputs, mesh), shape.seq_len)
    else:
        cache = zoo.cache_specs(cfg, rt, shape)
        c_bytes = _bytes(cache)
        cspecs = zoo.cache_pspecs(cache, axes)
        flash = rt.flash_decode and cfg.family in ("dense", "moe", "vlm", "encdec")
        if flash and cfg.family == "encdec":  # the decoder's self caches; the cross K/V whole
            cspecs = dict(cspecs, self=_seq_sharded(cache["self"], cspecs["self"]))
        elif flash:
            cspecs = _seq_sharded(cache, cspecs)
        local_cache = _local(cache, cspecs, axes)
        resident += _bytes(local_cache)
        with roofline.trace() as tr, torch.no_grad():
            full = train.gather_tree(local, pspecs, mesh)
            if not flash:
                local_cache = mesh_lib.tree_map_specs(
                    lambda t, sp: _rows_local(t, sp, mesh, shape.global_batch), cache, cspecs)
            elif cfg.family == "encdec":
                local_cache = dict(local_cache, xkv=mesh_lib.tree_map_specs(
                    lambda t, sp: _rows_local(t, sp, mesh, shape.global_batch),
                    cache["xkv"], cspecs["xkv"]))
            api.decode_fn(full, local_cache, local_in["tokens"], shape.seq_len - 1)
    return tr, resident, _bytes(params), c_bytes


def lower_cell(arch_id: str, shape_name: str, mesh, args) -> dict:
    cfg = get_arch(arch_id)
    shape = SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    rec = {
        "arch": arch_id, "shape": shape_name, "kind": shape.kind,
        "mesh": "x".join(str(s) for s in mesh.mesh.shape),
        "quant": args.train_quant if shape.kind == "train" else args.quant,
        "cache": args.cache if shape.kind == "decode" else "-",
        "tag": args.tag,
    }
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    n_chips = mesh.mesh.numel()
    t0 = time.time()
    rt = make_runtime(shape.kind, args, mesh)
    tr, resident, p_bytes, c_bytes = trace_cell(cfg, shape, mesh, rt)
    rl = roofline.analyse(tr, roofline.model_flops(cfg, shape, n_chips), resident)
    rec.update(status="ok", trace_s=round(time.time() - t0, 1))
    rec["params_gib_per_dev"] = round(p_bytes / n_chips / 2**30, 3)
    if shape.kind == "decode":
        rec["cache_gib_per_dev"] = round(c_bytes / n_chips / 2**30, 3)
        # textbook decode memory roofline: read params once + cache once
        rec["t_memory_analytic_s"] = (p_bytes + c_bytes) / n_chips / roofline.HBM_BW
    rec.update(**rl.row())
    rec["fits_hbm"] = rl.peak_mem_bytes <= roofline.HBM_BYTES
    rec["kernels"] = {k: v["calls"] for k, v in tr.kernels.items()}
    rec["cost_source"] = ("meta trace (aten ops unfused: HBM bytes an upper bound; the kernels' "
                          "own counts)")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--quant", default="fake", choices=["none", "fake", "fake_full", "packed"])
    ap.add_argument("--train-quant", default="none", choices=["none", "fake", "fake_full"])
    ap.add_argument("--cache", default="bf16", choices=["bf16", "int8", "bcq4"])
    ap.add_argument("--attn-chunk", type=int, default=1024,
                    help="query chunk of the masked-softmax attention (Runtime.attn_chunk)")
    ap.add_argument("--logit-chunk", type=int, default=512)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-unroll", action="store_true",
                    help="accepted: a meta trace undercounts no loop")
    ap.add_argument("--flash-decode", action="store_true",
                    help="sequence-sharded decode attention over 'model'")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--moe-spec", default="fsdp", choices=["fsdp", "tp2d"])
    ap.add_argument("--param-layout", default="fsdp", choices=["fsdp", "tp"],
                    help="'tp' = serving layout: no FSDP weight gathers")
    ap.add_argument("--attn-bf16", action="store_true",
                    help="bf16 attention scores with an f32 softmax (Runtime.attn_f32=False)")
    ap.add_argument("--tag", default="", help="free-form label copied to the record")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    zoo.MOE_EXPERT_SPEC = args.moe_spec
    zoo.PARAM_LAYOUT = args.param_layout

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    init_fake_group(512 if True in meshes else 256)

    out_f = open(args.out, "a") if args.out else None
    n_ok = n_fail = n_skip = 0
    for multi in meshes:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi)
        for a in archs:
            for s in shapes:
                try:
                    rec = lower_cell(a, s, mesh, args)
                except Exception as e:  # a failure here is a bug in the system
                    rec = {
                        "arch": a, "shape": s,
                        "mesh": "x".join(str(n) for n in mesh.mesh.shape),
                        "tag": args.tag, "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-1500:],
                    }
                st = rec["status"]
                n_ok += st == "ok"
                n_fail += st == "FAIL"
                n_skip += st == "skipped"
                line = {k: v for k, v in rec.items() if k != "trace"}
                print(json.dumps(line), flush=True)
                if rec.get("trace"):
                    print(rec["trace"], flush=True)
                if out_f:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
    print(f"# dry-run done: ok={n_ok} skipped={n_skip} FAILED={n_fail}", flush=True)
    if out_f:
        out_f.close()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
