"""LO-BCQ encode: the first launch of the two-launch W4A4 GEMM, and the
bcq4 KV-page writer of the serving path.

Counterpart of ``repro/kernels/bcq_quantize.py``.  Both wrappers launch
csrc/bcq_quantize.cu (one encode pass, two output forms; design notes in
the source) for CUDA tensors:

* ``bcq_quantize`` — x (M, K) → packed idx, sel, ratio; for CPU tensors
  it runs its plain version ``ref.quantize_ref``.  Besides the two-launch
  GEMM it is the encode of ``bcq.fake_quant`` on CUDA tensors (the fake
  modes' activations, ``fake_full``'s weights, ``ptq.quantize_params``)
  and of ``bcq.encode_stats`` (the quant-error probe);
* ``bcq_page_write`` — one layer's new K and V encoded into their bcq4
  page slots in place, at decode (a token per row) or chunked prefill (a
  chunk per row).  It is reached through ``layers.paged_token_write`` /
  ``paged_chunk_write`` with ``kernel=True``, which own the choice: for
  CPU tensors, or with ``kernel=False``, they run the plain version (the
  reference's ``bcq.encode`` plus the last-writer scatter).

On meta tensors (the dry-run) both run their checks, make meta outputs
(the writer none: it writes in place) and add ``quantize_cost`` /
``page_write_cost`` to the build's meta count.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bcq import (BCQConfig, KernelRoute, check_kernel_codebooks,
                                  check_kernel_format, kernel_route)
from repro_torch.kernels import build
from repro_torch.kernels.ref import quantize_ref

BCQ_QUANTIZE = build.counter("bcq_quantize")
# the launches of BCQ_QUANTIZE that took the threshold search (non-integer
# codebooks — W4A4 fake-quant training after its first step — and every
# format but the default)
BCQ_QUANTIZE_THR = build.counter("bcq_quantize_thr")
BCQ_PAGE_WRITE = build.counter("bcq_page_write")


def quantize_cost(m: int, k: int, cfg: BCQConfig = BCQConfig(),
                  route: KernelRoute | None = None) -> tuple:
    """(HBM bytes, operations by unit) of the encode of (M, K) in ``cfg``'s
    format: x read in f32, idx, sel and the ratio written, the codebooks
    read; the encode on the CUDA cores, the table's count or the threshold
    search's (``build.encode_ops``), as ``route`` (by default
    ``kernel_route(cfg)``: integer books) says."""
    route = route or kernel_route(cfg)
    nbytes = (m * k * 4 + m * k // 2 + m * k // (2 * cfg.block_len) + m * k // cfg.array_len * 4
              + build.codebook_bytes(cfg) + 4)
    return nbytes, {"f32": build.encode_ops(cfg, route.table) * m * k}


def page_write_cost(k: torch.Tensor, rows: int, la: int, id_bytes: int,
                    cfg: BCQConfig = BCQConfig()) -> tuple:
    """(HBM bytes, operations by unit) of the page writer in ``cfg``'s
    format at L_A ``la``: K and V read, ``rows`` slots of each written
    (idx, sel, scale per head), the page ids and codebooks read; the
    encode on the CUDA cores, the count of the route ``kernel_route``
    gives the format at L_A ``la``."""
    h, d = k.shape[2], k.shape[3]
    nbytes = (2 * k.numel() * k.element_size()
              + 2 * rows * h * (d // 2 + d // (2 * cfg.block_len) + d // la)
              + id_bytes + build.codebook_bytes(cfg) + 8)
    table = kernel_route(dataclasses.replace(cfg, array_len=la)).table
    return nbytes, {"f32": build.encode_ops(cfg, table) * 2 * k.numel()}


def bcq_quantize(x: torch.Tensor, codebooks: torch.Tensor, s_x: torch.Tensor, cfg: BCQConfig):
    """Encode x (M, K) f32 with the per-tensor scale ``s_x`` (a 0-d
    tensor) → (idx u8 (M, K/2), sel u8 (M, K/16), ratio f32 (M, K/L_A)).
    K must be a multiple of L_A.  The codebooks are any sorted, finite f32
    levels: integer ones take the kernel's table, others (trained books)
    its threshold search — the choice is the entry check's, never a
    fallback.  The outputs are integer codes and a ratio with no gradient
    (``bcq.fake_quant`` decodes them with torch ops that carry it)."""
    if x.device.type == "cpu":
        return quantize_ref(x, codebooks, cfg, s_x)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"bcq_quantize: unsupported device {x.device}")
    check_kernel_format(cfg, "bcq_quantize kernel")
    whole = True  # a meta call counts the integer books' route
    if x.device.type == "cuda":
        whole = check_kernel_codebooks(codebooks, cfg, integer=False)
    route = kernel_route(cfg, whole)
    m, k = x.shape
    if k % cfg.array_len:
        raise ValueError(f"bcq_quantize kernel: K={k} is not a multiple of {cfg.array_len}")
    for name, t, dt, shape in (("x", x, torch.float32, (m, k)),
                               ("codebooks", codebooks, torch.float32,
                                (cfg.n_codebooks, cfg.n_entries)),
                               ("s_x", s_x, torch.float32, ())):
        build.check_tensor(f"bcq_quantize kernel: {name}", t, dt, shape, x.device)
    x = build.aligned(x, 16)  # the kernel reads x as float4
    idx = torch.empty((m, k // 2), dtype=torch.uint8, device=x.device)
    sel = torch.empty((m, k // (2 * cfg.block_len)), dtype=torch.uint8, device=x.device)
    ratio = torch.empty((m, k // cfg.array_len), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        build.add_meta_cost("bcq_quantize", *quantize_cost(m, k, cfg, route))
        return idx, sel, ratio
    if m == 0:
        return idx, sel, ratio
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), codebooks.data_ptr(), s_x.data_ptr(), idx.data_ptr(), sel.data_ptr(),
            ratio.data_ptr(), m, k, cfg.codeword_max)
    if route.table:
        build.check(lib.bcq_quantize_launch(*args, stream), "bcq_quantize_launch")
    else:
        build.check(lib.bcq_quantize_thr_launch(*args, *build.format_args(cfg),
                                                int(route.special), stream),
                    "bcq_quantize_thr_launch")
    BCQ_QUANTIZE.count += 1
    if not route.table:
        BCQ_QUANTIZE_THR.count += 1
    return idx, sel, ratio


def bcq_page_write(pool: dict, k, v, cfg: BCQConfig, cb, *, page_ids=None, offsets=None,
                   chunk_page_ids=None, chunk_len=None) -> dict:
    """Encode one layer's new keys and values (B, S, H, D), f32 or bf16,
    into the bcq4 page pool ``pool`` (leaves (P, ps, H, ·), pool-global
    ``k_sx`` / ``v_sx``) IN PLACE; returns the pool.

    Decode: ``page_ids``, ``offsets`` (B,) — row b's first token goes to
    slot (page_ids[b], offsets[b]); rows sharing a slot resolve last row
    wins.  Chunked prefill: ``chunk_page_ids`` (B, n_cp) — row b's tokens
    fill its pages from slot 0; slots past S and past ``chunk_len[b]`` (B,)
    get zeros; a page named twice is written by its last (b, j) in
    row-major order.  The same bytes as the plain writes of
    ``layers.paged_token_write`` / ``paged_chunk_write``.  CUDA tensors
    only: the layers run the plain version for CPU tensors."""
    if k.device.type not in ("cuda", "meta"):
        raise ValueError(f"bcq_page_write: unsupported device {k.device}")
    b, s, h, d = k.shape
    la = cfg.array_len if d % cfg.array_len == 0 else min(cfg.array_len, d)  # layers._cache_cfg
    check_kernel_format(dataclasses.replace(cfg, array_len=la), "bcq_page_write kernel")
    route = kernel_route(dataclasses.replace(cfg, array_len=la))
    if k.device.type == "cuda":
        check_kernel_codebooks(cb, cfg)
    if d % la or d > 256:
        raise ValueError(f"bcq_page_write kernel: unsupported d_head {d} (L_A {la})")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"bcq_page_write kernel: k {tuple(k.shape)} {k.dtype} and v "
                         f"{tuple(v.shape)} {v.dtype} must match, f32 or bf16")
    leaves = [pool[f"{nm}_{part}"] for nm in "kv" for part in ("idx", "sel", "scale")]
    n_pages, ps = leaves[0].shape[:2]
    for leaf, last in zip(leaves, (d // 2, d // (2 * cfg.block_len), d // la) * 2):
        build.check_tensor("bcq_page_write kernel: pool leaf", leaf, torch.uint8,
                           (n_pages, ps, h, last), k.device)
    if k.device.type == "cuda" and any(leaves[i].data_ptr() % 4 for i in (0, 1, 3, 4)):
        raise ValueError("bcq_page_write kernel: idx and sel leaves must be 4-byte aligned")
    for name in ("k_sx", "v_sx"):
        build.check_tensor(f"bcq_page_write kernel: {name}", pool[name], torch.float32, (),
                           k.device)
    build.check_tensor("bcq_page_write kernel: codebooks", cb, torch.float32,
                       (cfg.n_codebooks, cfg.n_entries), k.device)
    if chunk_page_ids is None:
        ids, aux, n_cp = page_ids, offsets, 0
        shapes = ((b,), (b,))
    else:
        ids, aux, n_cp = chunk_page_ids, chunk_len, chunk_page_ids.shape[1]
        shapes = ((b, n_cp), (b,))
    for name, t, shape in (("ids", ids, shapes[0]), ("aux", aux, shapes[1])):
        if t is None and name == "aux" and n_cp:
            continue  # no chunk_len: every row's chunk is S long
        if (t is None or t.device != k.device or t.dtype not in (torch.int32, torch.int64)
                or tuple(t.shape) != shape):
            got = "None" if t is None else f"{tuple(t.shape)} {t.dtype} on {t.device}"
            raise ValueError(f"bcq_page_write kernel: {name} is {got}, expected {shape} "
                             f"int32 or int64 on {k.device}")
    if k.device.type == "meta":  # the pool is written in place: no output to make
        rows = b if chunk_page_ids is None else b * n_cp * ps
        build.add_meta_cost("bcq_page_write", *page_write_cost(
            k, rows, la, sum(t.numel() * t.element_size() for t in (ids, aux) if t is not None),
            cfg))
        return pool
    if b == 0 or s == 0 or h == 0 or (n_cp == 0 and chunk_page_ids is not None):
        return pool
    if ids.ndim == 2 and ids.stride(1) != 1:
        ids = ids.contiguous()  # a row's chunk pages are read as one run
    k = build.aligned(k.contiguous(), 16)  # read in 16-byte words
    v = build.aligned(v.contiguous(), 16)
    status = build.library().bcq_page_write_launch(
        int(k.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(), pool["k_sx"].data_ptr(),
        pool["v_sx"].data_ptr(), cb.data_ptr(), *(leaf.data_ptr() for leaf in leaves),
        ids.data_ptr(), int(ids.dtype == torch.int64), ids.stride(0),
        None if aux is None else aux.data_ptr(), int(aux is not None and aux.dtype == torch.int64),
        0 if aux is None else aux.stride(0), b, s, h, d, n_pages, ps, n_cp, cfg.block_len, la,
        cfg.n_codebooks, cfg.n_entries, int(route.table), cfg.codeword_max,
        torch.cuda.current_stream(k.device).cuda_stream,
    )
    build.check(status, "bcq_page_write_launch")
    BCQ_PAGE_WRITE.count += 1
    return pool
