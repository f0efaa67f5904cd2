"""``launch/batching.py`` (``ContinuousBatcher``), the zoo's serving through
``PagedEngine``, the bucketed contiguous decode and the serve CLI's
contiguous half, against the JAX package and within the port, on the
2-layer smokes of the zoo's dense configs (and the vlm's for the batcher).

Weights are the reference's (``tests/test_torch_zoo.py``'s draw, carried
across by ``convert.from_numpy_tree``): W4A4 packed with ``lm_head`` left
float, a bcq4 cache, f32 compute; Qwen2's smoke (d_model 112) runs the
``fake_full`` on the float tree in both packages in place of the packed
forward, which neither runs at that width (``PACKED_AS_FAKE_FULL``).
Prompts are numpy-seeded.

Held token for token (no tolerance):

* port ``ContinuousBatcher`` vs ``repro.launch.batching.ContinuousBatcher``
  (2 slots over 4 requests, as ``tests/test_batching.py``): the same
  launches (one per position group, every slot in each), so the same W4A4
  activation scales;
* port ``PagedEngine`` vs ``repro.serving.PagedEngine`` (slab admission,
  ``paged_kernel=False`` on the reference's side);
* port ``PagedEngine`` vs port ``ContinuousBatcher`` at ``quant_mode="none"``
  for every cache kind, as ``tests/test_paged_engine.py:55`` (under W4A4
  the two engines' decode launches span different rows);
* the batcher vs sequential single-request serving at ``none``, as
  ``tests/test_batching.py``;
* the port's ``greedy_generate``, whose decode reads the written prefix,
  vs the reference's bucketed (``kv_bucket=8``) and whole-cache reads,
  every cache kind, as ``tests/test_paged_engine.py:416``.

The batcher comparison also holds every decode launch's inputs (tokens,
position, cache bytes) equal and its logits within 1e-5 relative.  One
named case parts (``W4A4_FLIPS``): Qwen1.5's smoke, where a launch on
byte-equal inputs moves by a 4-bit quantization step (the two packages'
f32 rounding meets a quantization boundary); the test holds that this is
the first launch to part and that the same launch at ``quant_mode="none"``
agrees within 1e-5.
"""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.launch.batching import ContinuousBatcher as TBatcher
from repro_torch.models import zoo as tzoo
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving.engine import PagedEngine as TPagedEngine
from repro_torch.serving.generate import Request as TRequest
from repro_torch.serving.generate import SamplingParams as TSampling
from repro_torch.serving.generate import greedy_generate as t_greedy_generate

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke  # noqa: E402
from repro.core import ptq as jptq  # noqa: E402
from repro.core.bcq import BCQConfig as JCfg  # noqa: E402
from repro.core.calibrate import default_universal_codebooks  # noqa: E402
from repro.launch.batching import ContinuousBatcher as JBatcher  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import Runtime as JRuntime  # noqa: E402
from repro.serving.engine import PagedEngine as JPagedEngine  # noqa: E402
from repro.serving.generate import Request as JRequest  # noqa: E402
from repro_torch.models.convert import from_numpy_tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["qwen2_0_5b", "starcoder2_3b", "phi3_medium_14b", "qwen1_5_32b"]
PACKED_AS_FAKE_FULL = {"qwen2_0_5b"}
CB = default_universal_codebooks(JCfg()).as_jnp()
# Qwen1.5's smoke parts from the reference in the batcher's 12th launch:
# its inputs and caches are byte-equal and every earlier launch agrees to
# 6e-7, but the two packages' f32 rounding (torch vs XLA on the CPU) sits
# at a 4-bit quantization boundary inside it, and the logits move by a
# quantization step (0.097); without the quantizers the launch agrees
W4A4_FLIPS = {"qwen1_5_32b"}
RTOL = 1e-5
MAX_LEN, PS, N_NEW = 32, 8, 4
LENGTHS = (5, 9, 7, 6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _no_lm_head(path, leaf):
    return jptq._is_gemm_weight(path, leaf) and "lm_head" not in path


@functools.lru_cache(maxsize=None)
def _served_floats(arch):
    """The reference's float tree of the smoke, with the codebooks."""
    base = JRuntime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32)
    floats = jax.jit(jzoo.build(get_smoke(arch), base).init)(jax.random.PRNGKey(0))
    floats["codebooks"] = CB
    return floats


@functools.lru_cache(maxsize=None)
def _served(arch):
    """(reference api, its tree, port api, its tree): W4A4 packed (or
    ``fake_full`` on the floats, ``PACKED_AS_FAKE_FULL``), bcq4."""
    cfg = get_smoke(arch)
    base = JRuntime(quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32,
                    cache_kind="bcq4", paged_kernel=False)
    floats = _served_floats(arch)
    packed = jax.jit(lambda p: jptq.pack_params(p, CB, JCfg(), predicate=_no_lm_head))(
        {k: v for k, v in floats.items() if k != "codebooks"})
    packed["codebooks"] = CB
    jmode, jtree = (("fake_full", floats) if arch in PACKED_AS_FAKE_FULL else ("packed", packed))
    japi = jzoo.build(cfg, dataclasses.replace(base, quant_mode=jmode))
    tapi = tzoo.build(t_get_smoke(arch), TRuntime(quant_mode=jmode, compute_dtype=torch.float32,
                                                  cache_kind="bcq4"), device="cpu")
    return japi, jtree, tapi, from_numpy_tree(_np(jtree))


def _prompts(cfg, lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lengths]


def _run(engine, prompts, request):
    for i, p in enumerate(prompts):
        engine.submit(request(rid=i, prompt=p, max_new=N_NEW))
    finished, ticks = engine.run_to_completion()
    return {r.rid: list(r.out) for r in finished}, ticks


# ----------------------------------------------------------- vs the reference
@pytest.mark.parametrize("arch", DENSE + ["pixtral_12b"])
def test_batcher_matches_reference_batcher(arch):
    """Token for token; every decode launch's inputs (tokens, position, the
    cache bytes) equal and its logits within 1e-5 relative, up to the one
    named W4A4 flip (``W4A4_FLIPS``), where a launch on equal inputs parts
    by a quantization step."""
    japi, jtree, tapi, ttree = _served(arch)
    prompts = _prompts(tapi.cfg)
    jlog, tlog = [], []
    jb = JBatcher(japi, jtree, n_slots=2, max_len=MAX_LEN)
    jdecode = jb._decode

    def jrec(p, c, t, pos):
        snap = _np(c)
        out = jdecode(p, c, t, pos)
        jlog.append((np.asarray(t), int(pos), snap, np.asarray(out[0])))
        return out

    def trec(p, c, t, pos):
        snap = {n: v.numpy().copy() for n, v in c.items()}
        out = tapi.decode_fn(p, c, t, pos)
        tlog.append((t.numpy().copy(), int(pos), snap, out[0].numpy().copy()))
        return out

    jb._decode = jrec
    want, jticks = _run(jb, prompts, JRequest)
    want = {rid: [int(t) for t in out] for rid, out in want.items()}
    bat = TBatcher(dataclasses.replace(tapi, decode_fn=trec), ttree, n_slots=2, max_len=MAX_LEN)
    got, ticks = _run(bat, prompts, TRequest)
    assert ticks == jticks and ticks < len(prompts) * (N_NEW + 1)
    assert len(tlog) == len(jlog)
    parted = None
    for k, ((jt, jp, jc, jl), (tt, tp, tc, tl)) in enumerate(zip(jlog, tlog)):
        assert np.array_equal(tt, jt) and tp == jp, k
        assert all(np.array_equal(tc[n], jc[n]) for n in jc), k
        if np.abs(tl - jl).max() > RTOL * np.abs(jl).max():
            parted = k
            break
    if arch not in W4A4_FLIPS:
        assert parted is None and got == want
    else:
        # inputs and caches equal, the logits a quantization step apart;
        # the same launch without the 4-bit quantizers agrees to rounding
        assert parted is not None and got != want
        jt, jp, jc, jl = jlog[parted]
        tl = tlog[parted][3]
        assert np.abs(tl - jl).max() > 1e-3 * np.abs(jl).max()
        floats = jax.tree.map(jnp.asarray, _np(_served_floats(arch)))
        jnone = jzoo.build(get_smoke(arch), JRuntime(
            quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32,
            cache_kind="bcq4"))
        tnone = tzoo.build(t_get_smoke(arch), TRuntime(compute_dtype=torch.float32,
                                                       cache_kind="bcq4"), device="cpu")
        jl0, _ = jax.jit(jnone.decode_fn)(floats, jax.tree.map(jnp.asarray, jc), jnp.asarray(jt),
                                          jnp.int32(jp))
        tl0, _ = tnone.decode_fn(from_numpy_tree(_np(_served_floats(arch))),
                                 {n: torch.from_numpy(v.copy()) for n, v in jc.items()},
                                 torch.from_numpy(jt.copy()), jp)
        np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(jl0)).max())
    # every token has its margin and launch: prefills and group decodes
    for r in bat.finished:
        assert len(r.margins) == len(r.launch_ids) == len(r.out)
        assert all(m >= 0 for m in r.margins)
    assert max(max(r.launch_ids) for r in bat.finished) == bat.launches - 1


@pytest.mark.parametrize("arch", DENSE)
def test_paged_engine_matches_reference_engine(arch):
    """The zoo's GQA groups (7, 2, 2, 1 query heads a KV head at the smoke)
    through both engines' paged decode and slab admission."""
    japi, jtree, tapi, ttree = _served(arch)
    prompts = _prompts(tapi.cfg, (5, 9, 7))
    want, _ = _run(JPagedEngine(japi, jtree, n_slots=2, max_len=MAX_LEN, page_size=PS), prompts,
                   JRequest)
    got, _ = _run(TPagedEngine(tapi, ttree, n_slots=2, max_len=MAX_LEN, page_size=PS,
                               device="cpu"), prompts, TRequest)
    assert got == {rid: [int(t) for t in out] for rid, out in want.items()}


# ------------------------------------------------------------ within the port
def _float_api(arch, kind):
    cfg = t_get_smoke(arch)
    api = tzoo.build(cfg, TRuntime(compute_dtype=torch.float32, cache_kind=kind), device="cpu")
    return api, api.init(0)  # a bcq4 cache's codebooks ride in the tree


@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "phi3_medium_14b"])
def test_paged_engine_matches_batcher(arch, kind):
    """Token for token at ``quant_mode="none"``, every cache kind; the
    paged engine never takes more ticks than the position-grouped batcher."""
    api, params = _float_api(arch, kind)
    prompts = _prompts(api.cfg, (5, 9, 7))
    ref, bticks = _run(TBatcher(api, params, n_slots=2, max_len=MAX_LEN), prompts, TRequest)
    got, ticks = _run(TPagedEngine(api, params, n_slots=2, max_len=MAX_LEN, page_size=PS,
                                   device="cpu"), prompts, TRequest)
    assert got == ref
    assert ticks <= sum(N_NEW + 1 for _ in prompts)


def test_batcher_matches_sequential_serving():
    """Each request alone (prefill, then ``N_NEW`` decode steps) gives the
    batcher's tokens; with 2 slots over 4 requests the work overlaps."""
    api, params = _float_api("starcoder2_3b", "bf16")
    prompts = _prompts(api.cfg)
    refs = {}
    for i, p in enumerate(prompts):
        refs[i] = t_greedy_generate(api, params, p[None], N_NEW + 1, MAX_LEN, device="cpu")[0].tolist()
    got, ticks = _run(TBatcher(api, params, n_slots=2, max_len=MAX_LEN), prompts, TRequest)
    assert got == refs
    assert ticks < sum(N_NEW + 1 for _ in prompts)


def test_batcher_refuses_forks_and_samples_by_position():
    """``n_samples > 1`` is refused at submit (a paged-engine feature); a
    seeded sampled request draws the tokens the paged engine draws (keys
    by seed, sample index and position)."""
    api, params = _float_api("qwen1_5_32b", "bf16")
    bat = TBatcher(api, params, n_slots=2, max_len=MAX_LEN)
    fork = TRequest(rid=0, prompt=np.arange(5, dtype=np.int32), max_new=2, n_samples=2)
    bat.submit(fork)
    assert fork.done and fork.error.kind == "invalid" and "paged" in fork.error
    sp = TSampling(temperature=0.8, top_k=20, seed=5)
    prompts = _prompts(api.cfg, (6, 9))
    outs = []
    for eng in (TBatcher(api, params, n_slots=2, max_len=MAX_LEN),
                TPagedEngine(api, params, n_slots=2, max_len=MAX_LEN, page_size=PS, device="cpu")):
        for i, p in enumerate(prompts):
            eng.submit(TRequest(rid=i, prompt=p, max_new=N_NEW, sampling=sp))
        fin, _ = eng.run_to_completion()
        outs.append({r.rid: list(r.out) for r in fin})
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kind", ["bf16", "int8", "bcq4"])
def test_prefix_read_matches_reference_bucketed_and_full_reads(kind):
    """The port's ``greedy_generate`` (each decode reads the written
    prefix) gives the tokens of the reference's ``greedy_generate`` with
    ``kv_bucket=8`` (the read bounded to the prefix rounded up to 8) and
    of its whole-cache read, on the same float weights."""
    from repro.serving.generate import greedy_generate as j_greedy_generate

    floats = _served_floats("qwen2_0_5b")
    japi = jzoo.build(get_smoke("qwen2_0_5b"), JRuntime(
        quant_mode="none", compute_dtype=jnp.float32, param_dtype=jnp.float32, cache_kind=kind))
    tapi = tzoo.build(t_get_smoke("qwen2_0_5b"), TRuntime(compute_dtype=torch.float32,
                                                          cache_kind=kind), device="cpu")
    prompts = np.random.default_rng(3).integers(0, tapi.cfg.vocab, (2, 6)).astype(np.int32)
    got = t_greedy_generate(tapi, from_numpy_tree(_np(floats)), prompts, 6, MAX_LEN,
                            device="cpu").numpy()
    for bucket in (8, 0):
        want = j_greedy_generate(japi, floats, jnp.asarray(prompts), 6, MAX_LEN, kv_bucket=bucket)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"kv_bucket {bucket}")


# -------------------------------------------------------------------- CLI
def test_cli_serves_the_zoo_contiguously_and_paged(capsys):
    from repro_torch.launch.serve import main

    base = ["--smoke", "--device", "cpu", "--batch", "2", "--gen", "4"]
    packed = ["--arch", "starcoder2_3b", "--packed"] + base
    assert main(packed + ["--kv-bucket", "8"]) == 0
    out = capsys.readouterr().out
    for head in ("float  :", "W4A4   :", "packed :"):
        assert head in out
    assert "contiguous: 8 tokens" in out and "kv bucket 8" in out and "agreement vs float" in out
    assert "fused W4A4 linear kernel" in out
    main(packed + ["--unfused"])
    assert "decode + matmul (--unfused)" in capsys.readouterr().out
    main(packed + ["--paged"])
    assert "paged outputs == contiguous engine (2 of 2 requests equal)" in capsys.readouterr().out
    # Qwen2's smoke (d_model 112): float and W4A4 serve, paged too; its
    # packed forward refuses K = 112, as the reference's does
    qwen2 = ["--arch", "qwen2_0_5b"] + base
    assert main(qwen2) == 0 and "W4A4   :" in capsys.readouterr().out
    main(qwen2 + ["--paged"])
    assert "paged outputs == contiguous engine (2 of 2 requests equal)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="K=112"):
        main(qwen2 + ["--packed"])


def test_cli_refuses_paged_serving_of_the_vlm():
    """``--paged`` on pixtral exits with the typed error naming ``vlm`` and
    the servable families; contiguous serving runs."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "pixtral_12b", "--smoke",
           "--device", "cpu", "--batch", "2", "--prompt-len", "10", "--gen", "3"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    for extra in (["--paged"], ["--chaos"], ["--best-of", "2"]):
        res = subprocess.run(cmd + extra, capture_output=True, text=True, env=env, cwd=ROOT)
        assert res.returncode != 0
        assert "UnsupportedModelError" in res.stderr and "family 'vlm'" in res.stderr
        assert "paged-servable families: dense, moe, ssm, hybrid, encdec" in res.stderr
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT)
    assert res.returncode == 0 and "contiguous: 6 tokens" in res.stdout, res.stderr
