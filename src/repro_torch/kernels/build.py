"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` and linked into one shared library with
a plain C interface, loaded with ``ctypes``.  The build happens on first
use, into ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``); the library's file name carries a hash of the flags and
of every source and header under ``csrc/``, so an edited source or
shared header is rebuilt and an unchanged tree reused.

Each kernel wrapper keeps a :class:`LaunchCounter` that it bumps where
(and only where) it launches its kernel; ``reset_counts`` / ``counts``
let a script show which kernels a run went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("bcq_linear.cu", "page_gather.cu", "bcq_quantize.cu", "bcq_matmul.cu",
           "flash_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w_idx, w_sel, w_inv, cb, s_x, codes, a_inv, out, M, N, K, cw_max, stream
    "bcq_linear_launch": (_P,) * 9 + (_I, _I, _I, _F, _P),
    # kind, q, k0..k2, v0..v2, k_sx, v_sx, cb, tables, kv_len, out, part,
    # B, C, H, Hkv, D, ps, maxp, la, split_pages, scale, stream
    "page_gather_launch": (_I,) + (_P,) * 14 + (_I,) * 9 + (_F, _P),
    # x, cb, s_x, idx, sel, ratio, M, K, cw_max, stream
    "bcq_quantize_launch": (_P,) * 6 + (_I, _I, _F, _P),
    # a_idx, a_sel, a_inv, w_idx, w_sel, w_inv, cb_a, cb_w, out, M, N, K, stream
    "bcq_matmul_launch": (_P,) * 9 + (_I, _I, _I, _P),
    # dtype, q, k, v, out, BH, S, D, causal, scale, stream
    "flash_attention_launch": (_I,) + (_P,) * 4 + (_I,) * 4 + (_F, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built (no nvcc, or a compile error)."""


class LaunchCounter:
    """Launches of one kernel; its wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


COUNTERS: dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


def counts() -> dict[str, int]:
    return {n: c.count for n, c in COUNTERS.items()}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA "
            "toolkit is needed to build the kernels in src/repro_torch/csrc"
        )
    return nvcc


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted({*SOURCES, *(p.name for p in CSRC.glob("*.cuh"))}):
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"libreprotorch-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels (parallel nvcc, one process per source) unless
    an up-to-date library exists.  Returns the library path; the ptxas
    report (registers, shared memory, spills) lands beside it as
    ``build.log``."""
    lib = _lib_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    procs = []
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs, failed = [], [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src}\n{out}")
        objs.append(str(obj))
        if p.returncode:
            failed.append(src)
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp / lib.name), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        if link.returncode:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise KernelBuildError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    os.replace(tmp / lib.name, lib)  # atomic: concurrent builds agree
    shutil.rmtree(tmp, ignore_errors=True)
    return lib


_LIB = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``shape`` ``dtype`` tensor on
    ``device`` (what a kernel's C entry takes on trust)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"expected {tuple(shape)} {dtype} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned(t, nbytes: int):
    """``t``, or a fresh copy when its data does not start on an
    ``nbytes`` boundary (a kernel reading it in wide words needs that)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def check(status: int, name: str) -> None:
    """Raise on a non-zero CUDA status from a C entry."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with status {status}")
