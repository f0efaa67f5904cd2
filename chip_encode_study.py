#!/usr/bin/env python3
"""Design variants of the LO-BCQ encode pass (csrc/bcq_encode.cuh) timed
against the committed one, on one NVIDIA GPU.

    python3 chip_encode_study.py [--baseline DIR]

Each variant is a text patch of a copy of the committed csrc/ (under the
ignored build/encode_study/), built into a library of its own with the
port's nvcc flags; all builds run at once.  ``--baseline DIR`` adds the
csrc/ of another checkout (for example the parent, unpacked with
``git archive`` into the ignored build/).  Every library's
``bcq_quantize_launch`` must write the committed kernel's bytes; then each
is timed on the same seeded activation at (8192, 768) and (8192, 3072),
in turns forward through the variants and back: device ms per call
(torch.profiler) and the event loop of the raw C entry.  Not part of the
smoke; ``chip_smoke.py`` holds the committed kernel to its plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys

import chip_smoke as cs

# bcq_encode.cuh as committed → the variant; each old text must occur once
ONE_COPY = [("constexpr int VAL_COPIES = 8;", "constexpr int VAL_COPIES = 1;")]
NO_PREFETCH = [
    ("    const long long nxt_job = io.load(g + stride, n_blocks, nxt, nxt_sx);\n",
     "    long long nxt_job;\n"),
    ("    }\n#pragma unroll\n    for (int i = 0; i < LB; ++i) y[i] = nxt[i];\n",
     "    }\n    nxt_job = io.load(g + stride, n_blocks, nxt, nxt_sx);\n"
     "#pragma unroll\n    for (int i = 0; i < LB; ++i) y[i] = nxt[i];\n"),
]
TWO_CTAS = [
    ("ENC_THREADS, 0);\n    }\n",
     "ENC_THREADS, 0);\n      if (per_sm[dev] > 2) per_sm[dev] = 2;\n    }\n"),
]
# a val row holds the 8 codewords as bf16 (exact for integers ≤ 31) in one
# 16-byte row: one 128-bit read a scalar, each codeword unpacked by a shift
# or a mask
BF16_ROWS = [
    ("  float4 val_lo[LUT_N * VAL_COPIES];  // codebooks 0-3 per row\n"
     "  float4 val_hi[LUT_N * VAL_COPIES];  // codebooks 4-7 per row\n",
     "  uint4 val16[LUT_N * VAL_COPIES];\n"),
    ("    t.val_lo[p] = make_float4(w[0], w[1], w[2], w[3]);\n"
     "    t.val_hi[p] = make_float4(w[4], w[5], w[6], w[7]);\n",
     "    uint32_t h[NC / 2];\n"
     "#pragma unroll\n"
     "    for (int c = 0; c < NC / 2; ++c)\n"
     "      h[c] = __float_as_uint(w[2 * c]) >> 16 | (__float_as_uint(w[2 * c + 1]) & 0xFFFF0000u);\n"
     "    t.val16[p] = make_uint4(h[0], h[1], h[2], h[3]);\n"),
    ("  const uint32_t vlo = smem(t.val_lo + copy) - ROW0 * (16u * VAL_COPIES);\n"
     "  const uint32_t vhi = smem(t.val_hi + copy) - ROW0 * (16u * VAL_COPIES);\n",
     "  const uint32_t v16 = smem(t.val16 + copy) - ROW0 * (16u * VAL_COPIES);\n"),
    ("    const float4 lo = lds_f4(vlo + bits[i] * (16u * VAL_COPIES));\n"
     "    const float4 hi = lds_f4(vhi + bits[i] * (16u * VAL_COPIES));\n"
     "    const float w[NC] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};\n",
     "    uint4 pk;\n"
     "    asm volatile(\"ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\"\n"
     "                 : \"=r\"(pk.x), \"=r\"(pk.y), \"=r\"(pk.z), \"=r\"(pk.w)\n"
     "                 : \"r\"(v16 + bits[i] * (16u * VAL_COPIES)));\n"
     "    const float w[NC] = {__uint_as_float(pk.x << 16), __uint_as_float(pk.x & 0xFFFF0000u),\n"
     "                         __uint_as_float(pk.y << 16), __uint_as_float(pk.y & 0xFFFF0000u),\n"
     "                         __uint_as_float(pk.z << 16), __uint_as_float(pk.z & 0xFFFF0000u),\n"
     "                         __uint_as_float(pk.w << 16), __uint_as_float(pk.w & 0xFFFF0000u)};\n"),
]
VARIANTS = (("committed: 8 copies of the val rows, prefetch, as many CTAs as fit", []),
            ("1 copy of the val rows", ONE_COPY),
            ("no prefetch", NO_PREFETCH),
            ("at most 2 CTAs per SM", TWO_CTAS),
            ("bf16 val rows", BF16_ROWS),
            ("bf16 val rows, 1 copy", BF16_ROWS + ONE_COPY))


def patched_csrc(name, patches, out):
    """A copy of the committed csrc/ at ``out`` with ``patches`` applied to
    bcq_encode.cuh."""
    from repro_torch.kernels import build

    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    header = out / "bcq_encode.cuh"
    text = header.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            cs.fail(f"variant {name!r}: its patch does not match bcq_encode.cuh once:\n{old}")
        text = text.replace(old, new)
    header.write_text(text)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_encode_study: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a checkout whose src/repro_torch/csrc is timed too")
    args = ap.parse_args()

    from pathlib import Path

    from repro_torch.core import bcq
    from repro_torch.core.calibrate import default_universal_codebooks
    from repro_torch.kernels import bcq_quantize as bq
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "encode_study"
    variants = [(name, patched_csrc(name, patches, out_dir / f"src{i}"))
                for i, (name, patches) in enumerate(VARIANTS)]
    if args.baseline:
        variants.insert(0, (f"baseline {args.baseline}",
                            Path(args.baseline) / "src" / "repro_torch" / "csrc"))
    procs = []
    for i, (name, src) in enumerate(variants):
        lib = out_dir / f"variant{i}.so"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(src / "bcq_quantize.cu")]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (name, _), (lib, p) in zip(variants, procs):
        log = p.communicate()[0]
        if p.returncode:
            cs.fail(f"variant {name!r} did not build:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"variant {name}: {regs}", flush=True)
        fn = ctypes.CDLL(str(lib)).bcq_quantize_launch
        fn.argtypes, fn.restype = list(build._SIGNATURES["bcq_quantize_launch"]), ctypes.c_int
        libs.append(fn)
    cfg = bcq.BCQConfig()
    cb = default_universal_codebooks().as_tensor("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for m, k in ((cs.EVAL_SEQ * cs.EVAL_BATCH, 768), (cs.EVAL_SEQ * cs.EVAL_BATCH, 3072)):
        x = cs.activation(m, k, 7)
        s_x = bcq.tensor_scale(x, cfg)
        want = bq.bcq_quantize(x, cb, s_x, cfg)
        outs = [torch.empty_like(t) for t in want]
        ptrs = [t.data_ptr() for t in (x, cb, s_x, *outs)] + [m, k, cfg.codeword_max, stream]
        times = {i: [] for i in range(len(libs))}
        for i in list(range(len(libs))) + list(reversed(range(len(libs)))):
            call = lambda: build.check(libs[i](*ptrs), "bcq_quantize_launch")  # noqa: E731
            for t in outs:
                t.zero_()
            call()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                cs.fail(f"variant {variants[i][0]!r} writes other bytes than the committed kernel")
            times[i].append((cs.device_ms(cs.kernel_split_ms(call, iters=20)), cs.cuda_ms(call)))
        for i, (name, _) in enumerate(variants):
            dev = ", ".join("not measured" if d is None else f"{d:.4f}" for d, _ in times[i])
            ev = ", ".join(f"{e:.4f}" for _, e in times[i])
            print(f"encode study M={m} K={k} [{name}]: device {dev} ms; event loop {ev} ms; "
                  f"bytes equal", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
