"""The port's three examples (``examples/torch_*.py``, counterparts of
``examples/quickstart.py``, ``calibrate_and_eval.py`` and
``serve_w4a4.py``) run end to end on the CPU at tiny sizes: each ``main``
with ``--device cpu`` finishes and returns what it printed.  On the card
``chip_smoke.py``'s phase 25 runs them at their own device."""
import importlib.util
import math
from pathlib import Path

import torch

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_cpu(monkeypatch):
    """Steps 1–4 at a 64 × 256 operand: a non-increasing fit, LO-BCQ's
    NMSE below every baseline's, and the two W4A4 routes equal to each
    other bit for bit and within f32 rounding of the fake-quant product."""
    qs = _load("torch_quickstart")
    monkeypatch.setattr(qs, "X_SHAPE", (64, 256))
    monkeypatch.setattr(qs, "W_ROWS", 48)
    monkeypatch.setattr(qs, "GEMM_ROWS", 16)
    monkeypatch.setattr(qs, "FIT_ITERS", 3)
    out = qs.main(["--device", "cpu"])
    assert all(b <= a for a, b in zip(out["history"], out["history"][1:]))
    assert out["nmse"]["LO-BCQ"] < min(v for k, v in out["nmse"].items() if k != "LO-BCQ")
    assert out["gemm"].shape == (16, 48) and out["gemm"].device.type == "cpu"
    assert torch.equal(out["fused"], out["gemm"]) and torch.equal(out["gemm"], out["gemm_plain"])
    torch.testing.assert_close(out["gemm"], out["fake_quant"], rtol=1e-4, atol=1e-3)


def _short_fit(monkeypatch, mod):
    """The example's calibration at 2 LO-BCQ iterations (its own 12–15 are
    minutes on one CPU thread)."""
    real = mod.calibrate_from_model
    monkeypatch.setattr(mod, "calibrate_from_model",
                        lambda *a, **kw: real(*a, **dict(kw, iters=2)))
    return mod


def test_calibrate_and_eval_runs_on_cpu(monkeypatch):
    out = _short_fit(monkeypatch, _load("torch_calibrate_and_eval")).main(
        ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32"])
    names = [r[0] for r in out["rows"]]
    assert names[0] == "BF16 (pretrained)" and names[1].startswith("LO-BCQ W4A4")
    assert len(names) == 6 and all(math.isfinite(r[2]) for r in out["rows"])
    assert out["codebooks"].levels.shape == (8, 16)


def test_serve_w4a4_runs_on_cpu(monkeypatch):
    out = _short_fit(monkeypatch, _load("torch_serve_w4a4")).main(
        ["--device", "cpu", "--steps", "2", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert sorted(out["agreement"]) == ["bcq4", "bf16", "int8"]
    assert out["ref"].shape == out["w4a4"].shape == (2, 3)
