"""The port's quantize CLI (``repro_torch.launch.quantize``) against the JAX
package's, on the smoke ``gpt3_126m`` (2 layers).  Held here:

* ``quantize_checkpoint`` on the same float params and calibration tokens
  writes the reference's four artifacts: the codebooks equal (the fit's
  history within ``HIST_RTOL`` — the MSE of the unrounded Lloyd-Max
  levels, whose f32 sums add in another order — and non-increasing), the
  fake npz arrays and the packed npz bytes equal, the sidecars and the
  manifest equal;
* ``main`` runs on the CPU on a checkpoint the port's own manager saved;
* the fake and the packed artifact served through the port's
  ``PagedEngine`` (bcq4 pages, chunked prefill, depth 1) agree with the
  reference's engine serving its fake artifact in ``fake`` mode, under
  the margin rule with a logit tolerance ``TOL`` (W4A4 couples the rows
  of a launch through s_X, and the packed weights decode as
  ``cb · (1/(ŝ_A·s_X))`` where the fake ones are ``cb / (ŝ_A·s_X)``).
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.core import bcq as tbcq
from repro_torch.core import ptq as tptq
from repro_torch.launch import quantize as tquant
from repro_torch.models import zoo as tzoo
from repro_torch.models.convert import from_numpy_tree
from repro_torch.models.layers import Runtime as TRuntime
from repro_torch.serving import generate as tgen
from repro_torch.serving.engine import PagedEngine

TC = tbcq.BCQConfig()
HIST_RTOL = 2e-4
TOL = 1e-3
ENGINE = dict(n_slots=4, max_len=32, page_size=8, prefill_chunk=16, chunked_prefill=True)
# (prompt length, max_new): five requests on four slots
WORKLOAD = ((9, 6), (14, 4), (11, 5), (16, 3), (10, 4))


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")  # the parity side; absent where only the port runs
    import jax.numpy as jnp

    from repro.checkpoint import manager as ckpt
    from repro.configs.base import get_smoke
    from repro.core.bcq import BCQConfig
    from repro.data.pipeline import DataConfig, batch_at
    from repro.launch import quantize
    from repro.models import zoo
    from repro.models.layers import Runtime
    from repro.serving import generate
    from repro.serving.engine import PagedEngine as Engine

    return SimpleNamespace(jax=jax, jnp=jnp, ckpt=ckpt, get_smoke=get_smoke, BCQConfig=BCQConfig,
                           DataConfig=DataConfig, batch_at=batch_at, quantize=quantize, zoo=zoo,
                           Runtime=Runtime, gen=generate, Engine=Engine)


@pytest.fixture(scope="module")
def dense(ref):
    """Smoke gpt3_126m: the reference's float params (one jax.random draw)
    in both packages, and the quantize CLI's calibration tokens."""
    cfg = ref.get_smoke("gpt3_126m")
    rt = ref.Runtime(quant_mode="none", compute_dtype=ref.jnp.float32,
                     param_dtype=ref.jnp.float32)
    params = ref.zoo.build(cfg, rt).init(ref.jax.random.PRNGKey(0))
    toks = np.array(ref.batch_at(ref.DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=4),
                                   tquant.CALIB_STEP)["tokens"])
    return SimpleNamespace(cfg=cfg, tcfg=t_get_smoke("gpt3_126m"), params=params, toks=toks,
                           tparams=from_numpy_tree(ref.jax.tree.map(np.asarray, params)))


# -------------------------------------------------------------- quantize CLI
@pytest.fixture(scope="module")
def artifacts(ref, dense, tmp_path_factory):
    """The reference's and the port's quantize_checkpoint on the same params
    and calibration tokens (the reference calibrates at its defaults: 15
    iterations)."""
    d = tmp_path_factory.mktemp("ptq")
    jm = ref.quantize.quantize_checkpoint(dense.params, dense.cfg, ref.BCQConfig(),
                                          str(d / "ref"), ref.jnp.asarray(dense.toks))
    tm = tquant.quantize_checkpoint(dense.tparams, dense.tcfg, TC, str(d / "port"),
                                    torch.from_numpy(dense.toks))
    return SimpleNamespace(dir=d, jm=jm, tm=tm)


def test_quantize_checkpoint_writes_the_reference_artifacts(ref, artifacts):
    d = artifacts.dir
    jcb = json.loads((d / "ref" / "codebooks.json").read_text())
    tcb = json.loads((d / "port" / "codebooks.json").read_text())
    assert tcb["levels"] == jcb["levels"] and tcb["cfg"] == jcb["cfg"]
    np.testing.assert_allclose(tcb["history"], jcb["history"], rtol=HIST_RTOL)
    assert all(b <= a for a, b in zip(tcb["history"], tcb["history"][1:]))
    assert artifacts.tm == artifacts.jm
    assert (json.loads((d / "port" / "manifest.json").read_text())
            == json.loads((d / "ref" / "manifest.json").read_text()))
    for name in ("weights_w4_fake.npz", "weights_w4_packed.npz"):
        with np.load(d / "ref" / name) as zj, np.load(d / "port" / name) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=f"{name} {k}")
                assert zt[k].dtype == zj[k].dtype
        assert ((d / "port" / f"{name}.json").read_text()
                == (d / "ref" / f"{name}.json").read_text())


def test_quantize_main_on_a_port_checkpoint(tmp_path, dense, capsys):
    tckpt.CheckpointManager(str(tmp_path / "ck")).save(5, {"params": dense.tparams, "step": 5},
                                                       blocking=True)
    m = tquant.main(["--ckpt", str(tmp_path / "ck"), "--smoke", "--device", "cpu",
                     "--out", str(tmp_path / "w4")])
    assert m["bcq"]["bits"] == 4.5 and m["compression_vs_bf16"] > 1.5
    for name in ("codebooks.json", "weights_w4_fake.npz", "weights_w4_packed.npz",
                 "manifest.json"):
        assert (tmp_path / "w4" / name).exists()
    assert "artifacts in" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--array-len", "32"], ["--n-codebooks", "4"]])
def test_quantize_main_refuses_on_the_card_a_config_the_kernels_cannot_take(tmp_path, flags):
    """On the card (the default device) the kernels take only BCQConfig()'s
    L_A 64 and N_c 8: another config is refused before the checkpoint is
    read (there is none here) and before the device is resolved."""
    with pytest.raises(ValueError, match="the CUDA kernels take only L_A 64, L_b 8"):
        tquant.main(["--ckpt", str(tmp_path / "none"), "--smoke", "--out", str(tmp_path / "w4"),
                     *flags])


@pytest.mark.parametrize("mode", ["fake", "fake_full", "packed"])
def test_zoo_build_refuses_on_the_card_a_config_the_kernels_cannot_take(mode):
    rt = TRuntime(quant_mode=mode, bcq_cfg=tbcq.BCQConfig(array_len=32))
    with pytest.raises(ValueError, match="the CUDA kernels take only L_A 64, L_b 8"):
        tzoo.build(t_get_smoke("gpt3_126m"), rt, device="cuda")


def _tokens(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int64)


def _submit(eng, gen, vocab):
    for rid, (n, max_new) in enumerate(WORKLOAD):
        eng.submit(gen.Request(rid=rid, prompt=_tokens(vocab, n, rid), max_new=max_new))
    eng.run_to_completion()


@pytest.mark.parametrize("artifact", ["fake", "packed"])
def test_artifacts_serve_like_the_reference_fake_engine(ref, dense, artifacts, artifact):
    """The port serves its fake artifact (``quant_mode="fake"``) and its
    packed artifact (``"packed"``, the tree of ``packed_from_artifact``)
    through ``PagedEngine`` on bcq4 pages; the reference's engine serves its
    fake artifact.  Greedy tokens agree under the margin rule."""
    d = artifacts.dir
    jfake = ref.jax.tree.map(ref.jnp.asarray,
                             ref.ckpt.load_pytree(str(d / "ref" / "weights_w4_fake.npz")))
    jrt = ref.Runtime(quant_mode="fake", compute_dtype=ref.jnp.float32,
                      param_dtype=ref.jnp.float32, cache_kind="bcq4")
    jeng = ref.Engine(ref.zoo.build(dense.cfg, jrt), jfake, pipeline_depth=1, **ENGINE)
    _submit(jeng, ref.gen, dense.cfg.vocab)
    fake = tckpt.load_pytree(str(d / "port" / "weights_w4_fake.npz"))
    if artifact == "fake":
        params = fake
    else:
        params = tptq.packed_from_artifact(
            fake, tckpt.load_pytree(str(d / "port" / "weights_w4_packed.npz")))
    trt = TRuntime(quant_mode=artifact, compute_dtype=torch.float32, cache_kind="bcq4",
                   paged_kernel=True)
    teng = PagedEngine(tzoo.build(dense.tcfg, trt, device="cpu"), params, device="cpu",
                       **ENGINE)
    _submit(teng, tgen, dense.cfg.vocab)
    assert all(r.error is None for r in teng.finished)
    got = {(r.rid, r.sample_idx): r for r in teng.finished}
    want = {}
    for r in jeng.finished:
        g = got[(r.rid, r.sample_idx)]
        want[(r.rid, r.sample_idx)] = SimpleNamespace(
            out=list(r.out), launch_ids=list(g.launch_ids)[: len(r.out)], margins=list(g.margins))
    agree = tgen.greedy_agreement(want, got, TOL)
    assert agree["ok"], agree
    assert agree["equal_tokens"] > 0 and sorted(got) == sorted(want)
