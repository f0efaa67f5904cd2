"""Hygiene of the port: it imports neither JAX nor the JAX package, its
entry points run on the card unless asked for the CPU, and its kernel
build fails clearly without a CUDA toolkit."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
STUDY = ROOT / "chip_gate_study.py"
ENCODE_STUDY = ROOT / "chip_encode_study.py"
READ_STUDY = ROOT / "chip_read_study.py"
ROUTE_STUDY = ROOT / "chip_route_study.py"
TRAIN_STUDY = ROOT / "chip_train_study.py"
FLOOR_STUDY = ROOT / "chip_floor_study.py"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [SMOKE, STUDY, ENCODE_STUDY, READ_STUDY, ROUTE_STUDY,
                                             TRAIN_STUDY, FLOOR_STUDY, *EXAMPLES]
    assert len(files) > 10 and len(EXAMPLES) == 3
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files
        for m in _imports(f)
        if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro.")
    ]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch.serving.engine, repro_torch.launch.serve, repro_torch.models.convert\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.paged_attention\n"
        "import repro_torch.kernels.chunked_prefill, repro_torch.core.ptq\n"
        "import repro_torch.kernels.flash_attention, repro_torch.data.pipeline\n"
        "import repro_torch.serving.prefix, repro_torch.serving.prng\n"
        "import repro_torch.serving.faults, repro_torch.serving.audit\n"
        "import repro_torch.serving.telemetry, repro_torch.serving.events\n"
        "import repro_torch.serving.state_engine, repro_torch.models.ssm\n"
        "import repro_torch.models.hybrid, repro_torch.models.encdec\n"
        "import repro_torch.launch.train, repro_torch.optim.adamw, repro_torch.runtime.elastic\n"
        "import repro_torch.launch.batching\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
        "import repro_torch.optim.compress, repro_torch.runtime.pipeline\n"
        "from repro_torch.configs.base import ARCH_IDS, get_arch, get_smoke\n"
        "assert {get_arch(a).family for a in ARCH_IDS} >= {'dense', 'vlm'}\n"
        "assert [get_smoke(a).name for a in ARCH_IDS]\n"
        "import importlib.util\n"
        f"for path in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs.base import get_smoke
    from repro_torch.launch.serve import main
    from repro_torch.models import zoo
    from repro_torch.models.layers import Runtime
    from repro_torch.serving.engine import PagedEngine

    cfg = get_smoke("gpt3_126m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.build(cfg, Runtime())
    api = zoo.build(cfg, Runtime(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(api, api.init(0), n_slots=1, max_len=16, page_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--smoke", "--paged", "--chunked-prefill", "--batch", "1", "--gen", "2"])
    from repro_torch.serving.generate import greedy_generate

    params = api.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate(api, params, np.zeros((1, 4), np.int32), 2, 16)
    import importlib.util

    for path in EXAMPLES:  # the examples, counterparts of the reference's, as every entry point
        spec = importlib.util.spec_from_file_location(path.stem, path)
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.main([])
    # the slab functions run where their model was built: the CPU only when asked
    logits, caches = api.prefill_fn(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, 16)
    logits2, _ = api.decode_fn(params, caches, torch.zeros((1, 1), dtype=torch.int32), 4)
    assert {t.device.type for t in [logits, logits2, *caches.values()]} == {"cpu"}


def test_train_cli_defaults_to_the_card_and_runs_on_cpu(tmp_path, capsys):
    """``launch.train`` runs on the card unless ``--device cpu`` is given."""
    from repro_torch.launch.train import main

    args = ["--smoke", "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1",
            "--ckpt", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(args)
    params, loss = main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "step 2 loss" in out and np.isfinite(loss)
    assert {t.device.type for t in params["layers"]["mlp"]["wi"].values()} == {"cpu"}


def test_chip_smoke_fails_without_card_or_repository(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(SMOKE.read_text())
    runs = [(tmp_path, lone)]
    if not torch.cuda.is_available():
        runs.append((ROOT, SMOKE))
    for cwd, script in runs:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    real_exists = os.path.exists
    monkeypatch.setattr(build.os.path, "exists",
                        lambda p: False if "cuda" in str(p) else real_exists(p))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()


def test_build_hash_covers_shared_headers(monkeypatch, tmp_path):
    """A kernel library is rebuilt when a header that its sources include
    changes, not only when a listed source does."""
    from repro_torch.kernels import build

    assert (build.CSRC / "bcq_encode.cuh").exists()
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._lib_path()
    assert build._lib_path() == before
    header = tmp_path / "bcq_encode.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build._lib_path() != before
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert len({before, build._lib_path()}) == 2


def test_wrappers_refuse_other_devices():
    """Each wrapper runs its plain version on the CPU, its kernel on CUDA
    and its meta branch on meta tensors (the dry-run); any other device
    raises (a stand-in whose ``.device`` is an XLA device: no such tensor
    exists here)."""
    from types import SimpleNamespace

    from repro_torch.core.bcq import BCQConfig
    from repro_torch.kernels.bcq_linear import bcq_linear, bcq_linear_experts
    from repro_torch.kernels.bcq_matmul import bcq_matmul
    from repro_torch.kernels.bcq_quantize import bcq_page_write, bcq_quantize
    from repro_torch.kernels.common import page_gather_attention
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_kernel

    other = SimpleNamespace(device=torch.device("xla"), shape=(1, 1, 2, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        bcq_linear(other, None, None, None, None, None, BCQConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        bcq_linear_experts(other, None, None, None, None, None, BCQConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        page_gather_attention(other, {}, None, None, "bf16", BCQConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        bcq_quantize(other, None, None, BCQConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        bcq_page_write({}, other, other, BCQConfig(), None, page_ids=None, offsets=None)
    kv = torch.zeros((2, 1, 2, 64))
    with pytest.raises(ValueError, match="unsupported device"):  # layers run the plain write
        bcq_page_write({}, kv, kv, BCQConfig(), None, page_ids=None, offsets=None)
    with pytest.raises(ValueError, match="unsupported device"):
        bcq_matmul(other, None, None, None, None, None, None, None, BCQConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(other, other, other)
    cpu = torch.zeros((2, 8, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_kernel(cpu, cpu, cpu)  # the kernel never runs the plain version
    meta = torch.empty((4, 64), device="meta")  # the meta branch runs the kernel's checks
    with pytest.raises(ValueError, match="bcq_linear kernel: w_idx"):
        bcq_linear(meta, torch.empty((3, 5), dtype=torch.uint8, device="meta"),
                   None, None, None, None, BCQConfig())


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--smoke", "--paged", "--chunked-prefill", "--packed", "--batch", "2",
          "--prompt-len", "10", "--gen", "3", "--page-size", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "6 tokens" in out and "device=cpu" in out
    assert "contiguous engine" in out  # the batcher over the same model, compared
    assert main(["--smoke", "--device", "cpu", "--batch", "2", "--gen", "3"]) == 0  # contiguous
    out = capsys.readouterr().out
    assert "float  :" in out and "W4A4   :" in out and "contiguous: 6 tokens" in out


def test_host_tier_modules_import_with_jax_blocked():
    """``serving/pages.py`` (the host tier, its movers and ladder) and
    ``serving/prefix.py`` import and run with JAX and the JAX package
    blocked."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "from repro_torch.serving import pages, prefix\n"
        "tier = pages.HostPageTier(2)\n"
        "h = tier.put([np.arange(4, dtype=np.float32)], pages.KIND_KV)\n"
        "c = prefix.PrefixCache(); c.host_register(b'x', h)\n"
        "assert c.host_claim(b'x') == h and tier.take(h).nbytes == 16\n"
        "import importlib.util\n"
        f"for path in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_serve_cli_host_tier_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--smoke", "--paged", "--chunked-prefill", "--packed", "--batch", "2",
          "--prompt-len", "10", "--gen", "3", "--page-size", "8", "--device", "cpu",
          "--host-tier", "--host-pages", "4", "--recompress-after", "2"])
    out = capsys.readouterr().out
    assert "6 tokens" in out and "device=cpu" in out and "host tier: swap_outs" in out


def test_page_pool_accounting():
    from repro_torch.serving.pages import NULL_PAGE, PagePool, pages_needed

    pool = PagePool(4)
    pids = [pool.alloc() for _ in range(3)]
    assert NULL_PAGE not in pids and pool.alloc() is None and pool.used() == 3
    pool.ref(pids[0])
    assert not pool.deref(pids[0]) and pool.deref(pids[0])
    pool.release(pids[0])
    assert pool.available() == 1
    with pytest.raises(ValueError):
        pool.release(pids[1])  # still referenced
    assert [pages_needed(n, 8) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]
    assert np.int32(NULL_PAGE) == 0
