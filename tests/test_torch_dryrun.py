"""The port's dry-run and the kernels' meta branches, on the CPU.

* ``python -m repro_torch.launch.dryrun`` on the fake 256-rank production
  mesh: ``whisper_base``'s ``decode_32k`` (the reference's
  ``test_dryrun_one_cell_512dev`` cell) and ``gpt3_126m``'s train cell
  are ``"status": "ok"``, with ``params_gib_per_dev`` (and the decode
  cell's ``cache_gib_per_dev``) equal to the reference's analytic values
  from ``jax.eval_shape`` (``repro/launch/dryrun.py:153-161``);
* a spec its axes do not divide is ``"status": "FAIL"``;
* ``--attn-bf16`` and ``--attn-chunk`` are priced: ``gpt3_126m``'s
  ``prefill_32k`` at ``--attn-chunk 512 --attn-bf16`` moves fewer HBM
  bytes and peaks lower than with f32 scores over one whole chunk, and no
  record says a flag was ignored;
* each kernel wrapper's meta branch, at small shapes, gives the shapes
  and dtypes its plain version gives on the CPU, launches nothing, and
  adds its cost function's count.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.core import bcq
from repro_torch.core.calibrate import default_universal_codebooks
from repro_torch.kernels import build, ops
from repro_torch.kernels.bcq_linear import bcq_linear, bcq_linear_experts, linear_cost
from repro_torch.kernels.bcq_matmul import bcq_matmul, matmul_cost
from repro_torch.kernels.bcq_quantize import (bcq_page_write, bcq_quantize, page_write_cost,
                                              quantize_cost)
from repro_torch.kernels.common import gather_cost, page_gather_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_cost
from repro_torch.models import layers
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {("whisper_base", "decode_32k"), ("gpt3_126m", "train_4k")}

RUN = r"""
import json, sys
from repro_torch.launch import dryrun
from repro_torch.models import zoo
try:
    dryrun.main(["--arch", "whisper_base,gpt3_126m", "--shape", "decode_32k,train_4k",
                 "--mesh", "single", "--attn-bf16", "--attn-chunk", "512", "--out", sys.argv[1]])
except SystemExit as e:
    print("first exit", e.code)
real = zoo._spec_for
zoo._spec_for = lambda path, shape, axes: (
    ("model",) if "codebooks" in path else real(path, shape, axes))  # (8, 16) over 16 ranks
try:
    dryrun.main(["--arch", "whisper_base", "--shape", "decode_32k", "--mesh", "single",
                 "--tag", "undivided", "--out", sys.argv[1]])
except SystemExit as e:
    print("second exit", e.code)
zoo._spec_for = real
for tag, flags in (("f32_whole", ["--attn-chunk", "32768"]),
                   ("bf16_512", ["--attn-chunk", "512", "--attn-bf16"])):
    try:
        dryrun.main(["--arch", "gpt3_126m", "--shape", "prefill_32k", "--mesh", "single",
                     "--tag", tag, *flags, "--out", sys.argv[1]])
    except SystemExit as e:
        print(tag, "exit", e.code)
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(RUN), str(out)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert ("first exit 0" in r.stdout and "second exit 1" in r.stdout
            and "f32_whole exit 0" in r.stdout and "bf16_512 exit 0" in r.stdout), (
        r.stdout[-3000:] + r.stderr[-3000:])
    return [json.loads(line) for line in out.read_text().splitlines()]


def test_dryrun_cells_ok(records):
    ok = {(r["arch"], r["shape"]): r for r in records if r.get("tag") == ""}
    assert len(ok) == 4 and all(r["status"] == "ok" for r in ok.values()), ok
    for cell in CELLS:
        rec = ok[cell]
        assert rec["mesh"] == "16x16"
        assert rec["t_compute_s"] > 0 and rec["t_memory_s"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        assert rec["cost_source"].startswith("meta trace")
        assert "ignored" not in rec["cost_source"]  # --attn-bf16 --attn-chunk 512: priced
    dec = ok["whisper_base", "decode_32k"]
    assert dec["kernels"]["bcq_quantize"] > 0  # W4A4 fake: B3's meta branch counted
    assert dec["coll_breakdown"]["all-gather"] > 0  # the FSDP weights and the 'model' cache blocks
    assert set(ok["gpt3_126m", "train_4k"]["coll_breakdown"]) == {"all-gather", "all-reduce"}


def test_dryrun_footprints_match_reference_analytic(records):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import SHAPES, get_arch
    from repro.models import zoo as r_zoo
    from repro.models.layers import Runtime

    def tree_bytes(tree):
        return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree) if hasattr(x, "dtype"))

    ok = {(r["arch"], r["shape"]): r for r in records if r["status"] == "ok"}
    for (arch, shape_name), rec in ok.items():
        shape = SHAPES[shape_name]
        rt = (Runtime(quant_mode="none", param_dtype=jnp.bfloat16) if shape.kind == "train"
              else Runtime(quant_mode="fake", param_dtype=jnp.bfloat16))
        p_bytes = tree_bytes(jax.eval_shape(r_zoo.build(get_arch(arch), rt).init,
                                            jax.random.PRNGKey(0)))
        assert rec["params_gib_per_dev"] == round(p_bytes / 256 / 2**30, 3), (arch, shape_name)
        if shape.kind == "decode":
            c_bytes = tree_bytes(r_zoo.cache_specs(get_arch(arch), rt, shape))
            assert rec["cache_gib_per_dev"] == round(c_bytes / 256 / 2**30, 3)
            assert rec["t_memory_analytic_s"] == pytest.approx((p_bytes + c_bytes) / 256 / 3.35e12,
                                                               rel=1e-12)


def test_attention_flags_are_priced(records):
    """``--attn-chunk 512 --attn-bf16`` against f32 scores over one whole
    chunk on ``gpt3_126m``'s ``prefill_32k`` (2 × 32,768 tokens a rank):
    bf16 scores halve the score bytes of every pass over them (fewer HBM
    bytes in all, though each chunk reads K and V again), and 512-query
    chunks keep 1/64 of the scores live (a far lower peak); the model's
    work is the same."""
    by_tag = {r["tag"]: r for r in records if r["tag"] in ("f32_whole", "bf16_512")}
    whole, chunked = by_tag["f32_whole"], by_tag["bf16_512"]
    assert whole["status"] == chunked["status"] == "ok"
    assert chunked["hbm_bytes_per_dev"] < 0.75 * whole["hbm_bytes_per_dev"]
    assert chunked["peak_mem_gib"] < 0.25 * whole["peak_mem_gib"]
    assert chunked["model_flops_per_dev"] == whole["model_flops_per_dev"]
    assert chunked["flops_by_unit"]["bf16"] > whole["flops_by_unit"]["bf16"]  # scores on bf16
    for rec in (whole, chunked):
        assert "ignored" not in rec["cost_source"]


def test_undivided_spec_fails(records):
    bad = [r for r in records if r.get("status") == "FAIL"]
    assert len(bad) == 1 and "ShardingError" in bad[0]["error"], bad


# ------------------------------------------------------------ meta branches
def _meta(*ts):
    return tuple(t.to("meta") for t in ts)


def _like(meta_out, cpu_out):
    for m, c in zip(meta_out if isinstance(meta_out, tuple) else (meta_out,),
                    cpu_out if isinstance(cpu_out, tuple) else (cpu_out,)):
        assert m.device.type == "meta" and m.shape == c.shape and m.dtype == c.dtype


@pytest.fixture
def fresh():
    build.reset_meta_cost()
    build.reset_counts()
    yield
    assert not any(build.counts().values())  # a meta call launches nothing
    build.reset_meta_cost()


def test_meta_linear_matmul_and_quantize(fresh):
    cfg = bcq.BCQConfig()
    cb = default_universal_codebooks(cfg).as_tensor("cpu")
    g = torch.Generator().manual_seed(29)
    x = torch.randn((8, 128), generator=g)
    w = ops.quantize(torch.randn((24, 128), generator=g), cb, cfg)
    s_x = bcq.tensor_scale(x, cfg)
    args = (w.idx_packed, w.sel_packed, w.inv_scale, cb, s_x)
    _like(bcq_linear(*_meta(x, *args), cfg), bcq_linear(x, *args, cfg))
    xe = torch.randn((3, 5, 128), generator=g)
    stack = tuple(torch.stack([t] * 3) for t in args[:3])
    _like(bcq_linear_experts(*_meta(xe, *stack, cb, s_x), cfg),
          bcq_linear_experts(xe, *stack, cb, s_x, cfg))
    a = ops.quantize(x, cb, cfg)
    mm = (a.idx_packed, a.sel_packed, a.inv_scale, w.idx_packed, w.sel_packed, w.inv_scale, cb, cb)
    _like(bcq_matmul(*_meta(*mm), cfg), bcq_matmul(*mm, cfg))
    _like(bcq_quantize(*_meta(x, cb, s_x), cfg), bcq_quantize(x, cb, s_x, cfg))
    want = {"bcq_linear": linear_cost(1, 8, 128, 24),
            "bcq_linear_experts": linear_cost(3, 5, 128, 24),
            "bcq_matmul": matmul_cost(8, 128, 24), "bcq_quantize": quantize_cost(8, 128)}
    got = build.meta_cost()
    for name, (nbytes, ops_) in want.items():
        assert got[name]["calls"] == 1 and got[name]["bytes"] == nbytes
        assert {u: got[name][u] for u in ops_} == ops_


def test_meta_page_gather_page_write_and_flash(fresh):
    cfg = bcq.BCQConfig()
    cb = default_universal_codebooks(cfg).as_tensor("cpu")
    g = torch.Generator().manual_seed(30)
    pool = layers.cache_init(7, 8, 2, 64, "bcq4", cfg)
    k, v = (torch.randn((2, 1, 2, 64), generator=g) for _ in range(2))
    ids, offs = torch.tensor([1, 4], dtype=torch.int32), torch.tensor([3, 0], dtype=torch.int32)
    layers.paged_token_write(pool, k, v, ids, offs, "bcq4", cfg, cb)  # the plain writer
    mpool = {n: t.to("meta") for n, t in pool.items()}
    assert bcq_page_write(mpool, *_meta(k, v), cfg, cb.to("meta"), page_ids=ids.to("meta"),
                          offsets=offs.to("meta")) is mpool
    q = torch.randn((2, 3, 4, 64), generator=g)
    bt = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    kv_len = torch.tensor([20, 9], dtype=torch.int32)
    plain = page_gather_attention(q, pool, bt, kv_len, "bcq4", cfg, cb)
    _like(page_gather_attention(q.to("meta"), mpool, bt.to("meta"), kv_len, "bcq4", cfg,
                                cb.to("meta")), plain)
    qf = torch.randn((2, 16, 4, 32), generator=g).to(torch.bfloat16)
    _like(flash_attention(*_meta(qf, qf, qf)), flash_attention(qf, qf, qf))
    got = build.meta_cost()
    assert got["bcq_page_write"]["bytes"] == page_write_cost(k, 2, 64, 16)[0]
    assert got["page_gather"]["bytes"] == gather_cost(
        "bcq4", q, [pool["k_idx"], pool["k_sel"], pool["k_scale"]], bt, [20, 9])[0]
    assert got["flash_attention"]["bf16"] == flash_cost(8, 16, 32, torch.bfloat16)[1]["bf16"]


@pytest.mark.parametrize("fmt, integer, route", [
    ({}, True, (True, True)),                          # the default: table, compiled paths
    ({}, False, (False, True)),                        # trained books: the compiled search
    ({"codeword_bits": 8}, True, (False, True)),       # INT8 levels pass the table's rows
    ({"array_len": 32}, True, (False, False)),
    ({"n_codebooks": 16}, True, (False, False)),
    ({"block_len": 4, "array_len": 64}, True, (False, False)),
])
def test_kernel_route_and_the_quantize_bound_follow_it(fresh, fmt, integer, route):
    """One function decides a launch's route; B3's meta bound counts the
    operations of that route (a meta call cannot read the books: the
    integer books' route)."""
    cfg = bcq.BCQConfig(**fmt)
    assert tuple(bcq.kernel_route(cfg, integer)) == route
    cb = torch.zeros((cfg.n_codebooks, cfg.n_entries))
    x = torch.randn((8, 128), generator=torch.Generator().manual_seed(31))
    bcq_quantize(*_meta(x, cb, bcq.tensor_scale(x, cfg)), cfg)
    got = build.meta_cost()["bcq_quantize"]["f32"]
    assert got == quantize_cost(8, 128, cfg)[1]["f32"]
    assert got == build.encode_ops(cfg, bcq.kernel_route(cfg).table) * 8 * 128


def test_kv_pages_take_one_route_in_the_writer_and_the_reader():
    """The page writer and B2's bcq4 read route a format by its L_A at the
    head (``page_cfg``): L_A 128 at d_head 64 pages at L_A 64, the default."""
    from repro_torch.kernels.common import page_cfg

    wide = bcq.BCQConfig(array_len=128)
    assert bcq.kernel_route(page_cfg(wide, 64)) == bcq.kernel_route(bcq.BCQConfig())
    assert not bcq.kernel_route(page_cfg(wide, 128)).special
