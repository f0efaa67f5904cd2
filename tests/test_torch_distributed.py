"""The port's multi-device layer on gloo ranks against the reference on
JAX's host devices, on the CPU (no network: a file store in a temporary
directory).

One ``torch.multiprocessing.spawn`` of 8 ranks (``torch_dist_ranks.run``)
runs every scenario in turn, while one JAX subprocess with 8 host devices
computes the reference's results; both read the same seeded numpy inputs
(the port's smoke weights, saved by the fixture), and each writes an npz.

* ``compressed_allreduce_local`` over 8 ranks vs the reference's under
  ``jax.vmap(..., axis_name=...)``: bit-equal means and error buffers.
* ``make_compressed_dp_step`` (gpt3 smoke, (8,), 10 steps): losses within
  rtol 1e-4 of the reference's and falling.
* The sharded step on (4, 2), 8 steps: losses and gradient norms within
  rtol 1e-4 of the port's and the reference's single-device steps, the
  gathered params within the port's single-device ones.
* ``pipeline_apply`` on 4 stages (a (4, 2) mesh's 'pod' axis): forward
  within 1e-5 of the sequential stages and of the reference's
  ``pipeline_apply``, gradients within rtol 1e-4 / atol 1e-5 of the
  sequential ones (``tests/test_pipeline.py``'s bars).
* The sequence-sharded decode on (2, 4) (qwen1_5_32b smoke): within 1e-5
  of the port's gathered decode and 5e-3 of the reference's
  ``flash_decode`` (the reference's own bar).
* ``derive_mesh`` for n = 1…8 ranks, and the world's 8, as the
  reference's (``test_elastic_mesh_shrink``).
* ``all_gather`` over two axes and its gradient, and ``reduce_scatter``,
  against numpy.
* The train CLI on 2 ranks, one sent SIGTERM in the middle of a step:
  both ranks save the snapshot at the step's end in lockstep, the run
  goes on bit-equal to an uninterrupted one, and the snapshot resumed
  ends bit-equal to it too.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch.configs.base import get_smoke  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from torch_dist_ranks import flatten  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: torch on one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8

JAX_SIDE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_smoke
from repro.data.pipeline import DataConfig, batch_at
from repro.launch.train import make_compressed_dp_step, make_train_step
from repro.models import zoo
from repro.models.layers import Runtime
from repro.optim import adamw
from repro.optim.compress import compressed_allreduce_local, init_error_state
from repro.runtime.elastic import derive_mesh
from repro.runtime.pipeline import pipeline_apply
import dataclasses

inp = np.load(sys.argv[1])
out = {}

def tree(prefix):
    t = {}
    for key in inp.files:
        if key.startswith(prefix + "/"):
            node = t
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(inp[key])
    return t

mean, err = jax.vmap(lambda g, e: compressed_allreduce_local(g, e, "data"), axis_name="data")(
    jnp.asarray(inp["compress/g"]), jnp.asarray(inp["compress/err"]))
out["compress/mean"], out["compress/err"] = np.asarray(mean), np.asarray(err)

cfg = get_smoke("gpt3_126m")
rt = Runtime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32)
api = zoo.build(cfg, rt)
dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
params = tree("gpt3")
mesh = jax.make_mesh((8,), ("data",))
step = jax.jit(make_compressed_dp_step(api, adamw.AdamWConfig(lr=1e-3), mesh))
p, o, e, losses = params, adamw.init_state(params), init_error_state(params), []
with mesh:
    for s in range(10):
        p, o, e, m = step(p, o, e, batch_at(dcfg, s))
        losses.append(float(m["loss"]))
out["cdp/losses"] = np.array(losses)

single = jax.jit(make_train_step(api, adamw.AdamWConfig(lr=1e-3)))
p, o, losses, norms = params, adamw.init_state(params), [], []
for s in range(8):
    p, o, m = single(p, o, batch_at(dcfg, s))
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
out["single/losses"], out["single/norms"] = np.array(losses), np.array(norms)

pmesh = jax.make_mesh((4,), ("pod",), devices=jax.devices()[:4])
with pmesh:
    y = jax.jit(lambda w, x: pipeline_apply(lambda q, v: jnp.tanh(v @ q["w"]), {"w": w}, x,
                                            pmesh, "pod", n_micro=8))(
        jnp.asarray(inp["pipe/w"]), jnp.asarray(inp["pipe/x"]))
out["pipe/y"] = np.asarray(y)

qcfg = get_smoke("qwen1_5_32b")
dmesh = jax.make_mesh((2, 4), ("data", "model"))
rt1 = dataclasses.replace(rt, flash_decode=True, mesh=dmesh)
api1 = zoo.build(qcfg, rt1)
qparams = tree("qwen")
toks = jnp.asarray(inp["decode/tokens"])
with dmesh:
    _, c1 = jax.jit(lambda p, b: api1.prefill_fn(p, b, 24))(qparams, {"tokens": toks})
    r1, _ = jax.jit(api1.decode_fn)(qparams, c1, toks[:, :1], jnp.int32(16))
out["decode/flash"] = np.asarray(r1)

sizes = []
for n in range(1, 9):
    m = derive_mesh(n_devices=n, model_parallel=4)
    sizes.append([m.devices.size] + list(m.devices.shape))
out["derive/sizes"] = np.array(sizes)
out["derive/world"] = np.array(derive_mesh(model_parallel=4).devices.shape)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the port's per-rank results, the reference's results, the inputs)."""
    import torch.multiprocessing as mp

    import torch_dist_ranks

    work = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(29)
    rt = Runtime(quant_mode="none", compute_dtype=torch.float32, param_dtype=torch.float32)
    inp = {
        "compress/g": rng.normal(size=(WORLD, 37, 100)).astype(np.float32),
        "compress/err": (1e-3 * rng.normal(size=(WORLD, 37, 100))).astype(np.float32),
        "pipe/w": (0.3 * rng.normal(size=(4, 16, 16))).astype(np.float32),
        "pipe/x": rng.normal(size=(8, 16)).astype(np.float32),
        "pipe/w2": np.stack([0.9 * np.eye(8, dtype=np.float32)] * 4),
        "pipe/x2": rng.normal(size=(4, 8)).astype(np.float32),
        "decode/tokens": rng.integers(0, get_smoke("qwen1_5_32b").vocab, (4, 16)).astype(np.int32),
        "coll/x": rng.normal(size=(WORLD, 8, 3)).astype(np.float32),
        "coll/w": rng.normal(size=(WORLD, 8 * WORLD, 3)).astype(np.float32),
    }
    inp["compress/g"][3, 0, :5] = 0.0  # an all-but-zero row and exact zeros in the payload
    inp.update(flatten(zoo.build(get_smoke("gpt3_126m"), rt, device="cpu").init(0), "gpt3"))
    inp.update(flatten(zoo.build(get_smoke("qwen1_5_32b"), rt, device="cpu").init(0), "qwen"))
    np.savez(work / "inputs.npz", **inp)

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                            str(work / "inputs.npz"), str(work / "ref.npz")],
                           env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        mp.spawn(torch_dist_ranks.run, args=(WORLD, str(work)), nprocs=WORLD)
    finally:
        out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, f"STDOUT:{out[-2000:]}\nSTDERR:{err[-3000:]}"
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, dict(np.load(work / "ref.npz")), inp


def test_compressed_allreduce_matches_reference(results):
    """Bit-equal: the int8 payload's int32 sum is exact, and the scales are
    summed left to right in rank order, as XLA's psum sums them."""
    ranks, ref, _ = results
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["compress/mean"], ref["compress/mean"][r])
        np.testing.assert_array_equal(ranks[r]["compress/err"], ref["compress/err"][r])


def test_compressed_dp_step_matches_reference(results):
    ranks, ref, _ = results
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["cdp/losses"], ref["cdp/losses"], rtol=1e-4)
    assert ref["cdp/losses"][-1] < ref["cdp/losses"][0]
    assert ranks[0]["cdp/losses"][-1] < ranks[0]["cdp/losses"][0]


def test_sharded_step_matches_single_device(results):
    ranks, ref, _ = results
    single = ranks[0]
    for r in range(WORLD):
        got = ranks[r]
        np.testing.assert_allclose(got["sharded/losses"], single["single/losses"], rtol=1e-4)
        np.testing.assert_allclose(got["sharded/norms"], single["single/norms"], rtol=1e-4)
        np.testing.assert_allclose(got["sharded/losses"], ref["single/losses"], rtol=1e-4)
        np.testing.assert_allclose(got["sharded/norms"], ref["single/norms"], rtol=1e-4)
        assert set(got["sharded/coll_kinds"]) == {"all-gather", "all-reduce"}
        for key in got:
            if key.startswith("sharded/params/"):
                want = single["single/params/" + key[len("sharded/params/"):]]
                np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-5, err_msg=key)
    # each rank keeps its block: the (4, 2) layout holds less than the whole tree
    whole = sum(v.size for k, v in single.items() if k.startswith("single/params/"))
    assert all(int(ranks[r]["sharded/local_numel"]) < whole / 2 for r in range(WORLD))


def test_pipeline_matches_sequential_and_reference(results):
    ranks, ref, inp = results
    w, x = torch.from_numpy(inp["pipe/w"]), torch.from_numpy(inp["pipe/x"])
    seq = x
    for s in range(4):
        seq = torch.tanh(seq @ w[s])
    w2 = torch.from_numpy(inp["pipe/w2"]).clone().requires_grad_()
    h = torch.from_numpy(inp["pipe/x2"])
    for s in range(4):
        h = torch.tanh(h @ w2[s])
    (h ** 2).sum().backward()
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["pipe/y"], seq.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ranks[r]["pipe/y"], ref["pipe/y"], rtol=1e-5, atol=1e-5)
        stage = r // 2  # the (4, 2) mesh's 'pod' index
        np.testing.assert_allclose(ranks[r]["pipe/grad"], w2.grad[stage].numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_sequence_sharded_decode_matches(results):
    ranks, ref, _ = results
    for r in range(WORLD):
        rows = slice(2 * (r // 4), 2 * (r // 4) + 2)  # the (2, 4) mesh's 'data' block
        got = ranks[r]["decode/sharded"]
        np.testing.assert_allclose(got, ranks[r]["decode/gathered"][rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref["decode/flash"][rows], rtol=5e-3, atol=5e-3)
        assert set(ranks[r]["decode/coll_kinds"]) == {"all-reduce"}  # pmax and psums only


def test_derive_mesh_matches_reference(results):
    ranks, ref, _ = results
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["derive/sizes"], ref["derive/sizes"])
        np.testing.assert_array_equal(ranks[r]["derive/world"], ref["derive/world"])
    assert list(ref["derive/sizes"][5]) == [6, 3, 2]  # 4 does not divide 6: mp degrades
    assert list(ranks[0]["derive/world"]) == [2, 4]


def test_all_gather_gradient_and_reduce_scatter(results):
    """The gradient of a gather is the sum of every rank's cotangent, cut
    to this rank's block (JAX's transpose of ``all_gather``: a
    ``psum_scatter``); the block of rank r is the r-th in row-major mesh
    order, for the gather and the scatter alike."""
    ranks, _, inp = results
    x, w = inp["coll/x"], inp["coll/w"]
    total = w.astype(np.float64).sum(0)
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["coll/gathered"], x.reshape(-1, 3))
        block = total[8 * r:8 * r + 8]
        np.testing.assert_allclose(ranks[r]["coll/grad"], block, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ranks[r]["coll/scattered"], block, rtol=1e-5, atol=1e-5)
        assert set(ranks[r]["coll/kinds"]) == {"all-gather", "reduce-scatter"}


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    """The checkpoint directories of ``torch_dist_ranks.preempt`` on 2 gloo
    ranks."""
    import torch.multiprocessing as mp

    import torch_dist_ranks

    work = tmp_path_factory.mktemp("preempt")
    mp.spawn(torch_dist_ranks.preempt, args=(2, str(work)), nprocs=2)
    return work


def test_sigterm_mid_step_saves_in_lockstep(preempted):
    """SIGTERM reaches rank 1 inside a step, before that step's gathers and
    all-reduces.  The snapshot is the step's end on both ranks (a save run
    from the handler would pair its gathers with the other rank's step and
    hang or write garbage); the run ends as the uninterrupted one, and so
    does the snapshot resumed."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from torch_dist_ranks import PREEMPT_IN, PREEMPT_STEPS

    def leaves(name, step):
        got = CheckpointManager(str(preempted / name)).restore(step)
        assert got is not None, (name, step)
        return flatten(got[1], "")

    assert CheckpointManager(str(preempted / "killed")).all_steps() == [PREEMPT_IN, PREEMPT_STEPS]
    want = leaves("straight", PREEMPT_STEPS)
    for name in ("killed", "resumed"):
        got = leaves(name, PREEMPT_STEPS)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}{k}")
