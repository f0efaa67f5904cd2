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
let a script show which kernels a run went through.  Called on meta
tensors a wrapper runs its checks, returns meta outputs and adds its
kernel's bytes and operations to ``META_COST`` instead.
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
# the format's fields as the C entries take them: lb, la, nc, ne; and a
# route flag (core/bcq.kernel_route)
_FMT = (_I,) * 4
_ROUTE = (_I,)
_SIGNATURES = {
    # x, w_idx, w_sel, w_inv, cb, s_x, codes, a_inv, out, M, N, K, cw_max, format, table,
    # special, stream
    "bcq_linear_launch": (_P,) * 9 + (_I, _I, _I, _F) + _FMT + _ROUTE * 2 + (_P,),
    # x, w_idx, w_sel, w_inv, cb, s_x, codes, a_inv, out, E, C, N, K, cw_max, format,
    # table, special, stream
    "bcq_linear_experts_launch": (_P,) * 9 + (_I, _I, _I, _I, _F) + _FMT + _ROUTE * 2 + (_P,),
    # kind, q, k0..k2, v0..v2, k_sx, v_sx, cb, tables, kv_len, out, part,
    # B, C, H, Hkv, D, ps, maxp, la, split_pages, scale, lb, nc, ne, stream
    "page_gather_launch": (_I,) + (_P,) * 14 + (_I,) * 9 + (_F, _I, _I, _I, _P),
    # x, cb, s_x, idx, sel, ratio, M, K, cw_max, stream (the default format)
    "bcq_quantize_launch": (_P,) * 6 + (_I, _I, _F, _P),
    # x, cb, s_x, idx, sel, ratio, M, K, cw_max, format, special, stream
    "bcq_quantize_thr_launch": (_P,) * 6 + (_I, _I, _F) + _FMT + _ROUTE + (_P,),
    # bf16, k, v, k_sx, v_sx, cb, k_idx, k_sel, k_scale, v_idx, v_sel, v_scale,
    # ids, ids64, ids_stride, aux, aux64, aux_stride, B, S, H, D, P, ps, n_cp,
    # format (la: the pages' L_A), table, cw_max, stream
    "bcq_page_write_launch": ((_I,) + (_P,) * 12 + (_I, _I, _P) + (_I,) * 9 + _FMT + _ROUTE
                              + (_F, _P)),
    # a_idx, a_sel, a_inv, w_idx, w_sel, w_inv, cb_a, cb_w, out, M, N, K, format, special,
    # stream
    "bcq_matmul_launch": (_P,) * 9 + (_I, _I, _I) + _FMT + _ROUTE + (_P,),
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


def encode_ops(cfg, table: bool = True) -> int:
    """The encode's operations per scalar in ``cfg``'s format: the table's
    (per codebook a table read, d, d², Σ) or the threshold search's (per
    codebook log2(2^B) compares, a level read, d, d², Σ; then log2(2^B)
    compares for the winner's index)."""
    if table:
        return cfg.n_codebooks * (1 + 3)
    return cfg.n_codebooks * (cfg.index_bits + 1 + 3) + cfg.index_bits


def codebook_bytes(cfg) -> int:
    """The f32 codebooks a kernel reads: N_c × 2^B levels."""
    return cfg.n_codebooks * cfg.n_entries * 4


def format_args(cfg) -> tuple:
    """A format's fields in the C entries' order: L_b, L_A, N_c, 2^B."""
    return cfg.block_len, cfg.array_len, cfg.n_codebooks, cfg.n_entries

# The work of the kernels' calls on meta tensors (the dry-run's trace):
# kernel → {"calls", "bytes" (HBM, each input read once and each output
# written once), "int8" / "bf16" (tensor-core operations), "f32"
# (CUDA-core operations)}, the counts PERF.md's kernel table prices a
# bound with.  A meta call launches nothing and bumps no launch counter.
META_COST: dict = {}


def add_meta_cost(name: str, nbytes: float, ops: dict) -> None:
    row = META_COST.setdefault(name, {"calls": 0, "bytes": 0.0, "int8": 0.0, "bf16": 0.0,
                                      "f32": 0.0})
    row["calls"] += 1
    row["bytes"] += nbytes
    for unit, n in ops.items():
        row[unit] += n


def reset_meta_cost() -> None:
    META_COST.clear()


def meta_cost() -> dict:
    return {k: dict(v) for k, v in META_COST.items()}


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


K_STEP = 64  # the GEMM's step along K (csrc/bcq_gemm.cuh)


def pad_k(k: int) -> int:
    """The K the GEMM of B1, B1s and B4 walks: ``k`` rounded up to whole
    64-wide steps."""
    return -(-k // K_STEP) * K_STEP


def pad_last(t, n: int):
    """``t`` with zeros appended along its last dim up to ``n`` entries;
    ``t`` itself when it has them already (no copy)."""
    import torch

    extra = n - t.shape[-1]
    return t if extra == 0 else torch.nn.functional.pad(t, (0, extra))


def refuse_grad(what: str, *tensors) -> None:
    """The kernels have no backward (nor has the reference's Pallas call):
    raise where autograd records and an input requires grad, rather than
    return a result cut off from the graph (a silently missing gradient)."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad() or on inputs that do not "
            "require grad (the training forward runs the plain paths)")


def check(status: int, name: str) -> None:
    """Raise on a non-zero CUDA status from a C entry."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with status {status}")
