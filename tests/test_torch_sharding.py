"""The port's sharding rules and dry-run stand-ins against the reference's,
pure specs (no devices, no process group), for every arch of ``ARCH_IDS``:

* ``zoo.param_shapes`` equals ``jax.eval_shape(api.init)`` leaf by leaf
  (paths, shapes, dtypes) — float (f32) and W4A4 fake (bf16) trees;
* ``param_pspecs`` equals the reference's (``PartitionSpec`` → tuple) on
  the single- and multi-pod production meshes under both
  ``MOE_EXPERT_SPEC`` and both ``PARAM_LAYOUT`` values;
* for every ``SHAPES`` entry ``cell_is_applicable`` admits: the
  ``input_specs`` shapes and dtypes, ``batch_pspecs``, and for decode
  cells the ``cache_specs`` shapes and ``cache_pspecs`` (bf16 and bcq4);
* ``roofline.model_flops`` exactly, and ``cell_is_applicable`` alike.
"""
from __future__ import annotations

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as r_base  # noqa: E402
from repro.launch import roofline as r_roofline  # noqa: E402
from repro.models import zoo as r_zoo  # noqa: E402
from repro.models.layers import Runtime as RRuntime  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.launch import roofline as t_roofline  # noqa: E402
from repro_torch.models import zoo as t_zoo  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: torch on one thread)

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
MODES = {  # (port's Runtime, reference's Runtime)
    "none": (TRuntime(quant_mode="none"), RRuntime(quant_mode="none")),
    "fake_bf16": (TRuntime(quant_mode="fake", param_dtype=torch.bfloat16),
                  RRuntime(quant_mode="fake", param_dtype=jnp.bfloat16)),
}


def _flat(tree, prefix=""):
    """(path, shape, dtype name) of every leaf, sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{prefix}/{i}")]
    return [(prefix, tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


def _specs(specs, like, prefix=""):
    """(path, spec as a tuple) of a spec tree, walked along the tree ``like``
    it lays out (PartitionSpec → tuple)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _specs(specs[k], like[k], f"{prefix}/{k}")]
    if isinstance(like, (tuple, list)):
        return [x for i, v in enumerate(like) for x in _specs(specs[i], v, f"{prefix}/{i}")]
    return [(prefix, tuple(specs))]


@pytest.fixture(scope="module")
def trees():
    """{(arch, mode): (port's meta tree, reference's shape tree)}."""
    out = {}
    for arch in r_base.ARCH_IDS:
        for mode, (trt, rrt) in MODES.items():
            out[arch, mode] = (
                t_zoo.param_shapes(t_base.get_arch(arch), trt),
                jax.eval_shape(r_zoo.build(r_base.get_arch(arch), rrt).init,
                               jax.random.PRNGKey(0)))
    return out


@pytest.fixture
def layout():
    """Restores both packages' layout switches after a test."""
    saved = (t_zoo.MOE_EXPERT_SPEC, t_zoo.PARAM_LAYOUT, r_zoo.MOE_EXPERT_SPEC, r_zoo.PARAM_LAYOUT)
    yield
    t_zoo.MOE_EXPERT_SPEC, t_zoo.PARAM_LAYOUT, r_zoo.MOE_EXPERT_SPEC, r_zoo.PARAM_LAYOUT = saved


def test_arch_ids_and_shapes_are_copies():
    assert t_base.ARCH_IDS == r_base.ARCH_IDS
    assert {k: tuple(vars(v).values()) for k, v in t_base.SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in r_base.SHAPES.items()}


@pytest.mark.parametrize("arch", r_base.ARCH_IDS)
def test_param_shapes_match_eval_shape(trees, arch):
    for mode in MODES:
        port, ref = trees[arch, mode]
        assert _flat(port) == _flat(ref), (arch, mode)
        assert {t.device.type for t in _leaves(port)} == {"meta"}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", r_base.ARCH_IDS)
def test_param_pspecs_match_reference(trees, arch, layout):
    port, ref = trees[arch, "fake_bf16"]
    for moe in ("fsdp", "tp2d"):
        for lay in ("fsdp", "tp"):
            t_zoo.MOE_EXPERT_SPEC = r_zoo.MOE_EXPERT_SPEC = moe
            t_zoo.PARAM_LAYOUT = r_zoo.PARAM_LAYOUT = lay
            for axes in MESHES:
                got = _specs(t_zoo.param_pspecs(port, axes), port)
                want = _specs(r_zoo.param_pspecs(ref, axes), ref)
                assert got == want, (arch, moe, lay, axes)


@pytest.mark.parametrize("arch", r_base.ARCH_IDS)
def test_input_cache_and_batch_specs_match_reference(arch):
    tcfg, rcfg = t_base.get_arch(arch), r_base.get_arch(arch)
    trt, rrt = TRuntime(quant_mode="fake"), RRuntime(quant_mode="fake")
    for name, shape in r_base.SHAPES.items():
        ok, why = r_base.cell_is_applicable(rcfg, shape)
        assert t_base.cell_is_applicable(tcfg, t_base.SHAPES[name]) == (ok, why)
        if not ok:
            continue
        tin = t_zoo.input_specs(tcfg, trt, t_base.SHAPES[name])
        rin = r_zoo.input_specs(rcfg, rrt, shape)
        assert _flat(tin) == _flat(rin), (arch, name)
        for axes in MESHES:
            assert _specs(t_zoo.batch_pspecs(tin, axes), tin) == _specs(
                r_zoo.batch_pspecs(rin, axes), rin), (arch, name, axes)
        if shape.kind != "decode":
            continue
        for kind in ("bf16", "bcq4"):
            tc = t_zoo.cache_specs(tcfg, TRuntime(quant_mode="fake", cache_kind=kind),
                                   t_base.SHAPES[name])
            rc = r_zoo.cache_specs(rcfg, RRuntime(quant_mode="fake", cache_kind=kind), shape)
            assert _flat(tc) == _flat(rc), (arch, name, kind)
            for axes in MESHES:
                assert _specs(t_zoo.cache_pspecs(tc, axes), tc) == _specs(
                    r_zoo.cache_pspecs(rc, axes), rc), (arch, name, kind, axes)


@pytest.mark.parametrize("arch", r_base.ARCH_IDS + ["gpt3_126m"])
def test_model_flops_exactly_equal(arch):
    tcfg, rcfg = t_base.get_arch(arch), r_base.get_arch(arch)
    assert tcfg.param_count() == rcfg.param_count()
    assert tcfg.active_param_count() == rcfg.active_param_count()
    for name, shape in r_base.SHAPES.items():
        for n in (1, 256, 512):
            assert t_roofline.model_flops(tcfg, t_base.SHAPES[name], n) == \
                r_roofline.model_flops(rcfg, shape, n)
