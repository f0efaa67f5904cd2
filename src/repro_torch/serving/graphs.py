"""The decode tick as one CUDA graph per bucket (the counterpart of the
reference's per-bucket jit cache of ``_make_fused_decode`` and
``_make_fused_state_decode``).

A bucket is the key the engine launches under.  For the KV engine it is
W, the block table's width, which grows by doubling, so an engine
captures a handful of graphs over its life; for the state engine it is
whether the tick checkpoints (two graphs: with and without the scatter
into the state pages).  Each bucket owns a static input, the packed
int32 row — ``(n_slots, 3+W)`` (next token, ``use_host`` flag, kv length,
block table) or ``(n_slots, 5)`` (next token, ``use_host``, position,
checkpoint page, encoder page) — which the
engine fills with a ``non_blocking`` copy from pinned memory; the chain
token vector is a second static input, shared by every bucket and owned
by the engine.  The outputs — logits, greedy token, finite mask and
top-1 − top-2 margin — are static too: the next replay overwrites them,
so the engine copies what it keeps before it replays again.

Rules the graph relies on:

* **The pool never rebinds.**  The graph bakes in the data pointers of
  the parameters and of every page-pool leaf (the live cache tree, the
  state pool and an enc-dec model's encoder pool too); page writes,
  copy-on-write (``pages.copy_page``), slab scatters
  (``scatter_prefill_pages``), the state tree ops and the encoder page
  publish (``encdec.enc_store``) update the leaves in place, and nothing
  may replace one.  A state tick reads each row's encoder page through
  column 4 of the packed row, so a page published after the capture is
  read by the next replay.
* **Counters count replays.**  A replay makes no Python call, so a
  kernel wrapper's launch counter (``kernels/build.py``) would miss it.
  The counters' deltas over the capture are recorded, the capture's own
  Python calls are taken back (a capture launches nothing), and every
  replay adds the deltas: the counts equal an eager run's for the same
  ticks.
* **A capture error raises.**  Nothing falls back to eager.  A kernel's
  launch status is checked at capture only; a fault inside a replay (the
  KV-page writer's ``__trap`` on an out-of-range page, say) shows at the
  next synchronization, as an asynchronous CUDA error.

With a quant-error probe on the model (``Runtime.quant_probe``) the
capture also holds every probe site's encode (the quantize kernel, through
``bcq.encode_stats``) and its in-place writes into the recorder's two
buffers, which are static outputs like the others: the engine copies them
to pinned memory with the rest before the next replay
(``QuantProbeRecorder.fetch``).  A probe engine's buckets are therefore
graphs of their own, with more nodes than a default engine's
(``node_count`` counts either).

The first tick of a bucket is its warm-up: the tick runs eagerly on a
side stream (as ``torch.cuda.graphs`` asks before a capture) and its
outputs are the tick's; then the graph is captured from the same inputs
without running.  Each later tick of the bucket is one replay.  Every
capture draws on one memory pool shared across buckets, so the
workspaces (B1's encode codes and scales, B2's split partials) do not
grow with each W.  A captured graph is kept (``keep_graph``, instantiated
at its first replay), so that ``node_count`` can count the nodes a tick
launches (``cuGraphGetNodes``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels import build


@dataclasses.dataclass
class _Bucket:
    key: object  # the engine's bucket key, handed to the step function
    packed: torch.Tensor  # static input (n_slots, cols) int32
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: tuple = ()  # static (logits, nxt, fin, margin)
    deltas: dict = dataclasses.field(default_factory=dict)  # launches per replay


class DecodeGraphs:
    """One captured decode step per bucket key.

    ``fn(key, packed, chain_tok)`` is the engine's fused decode step for
    bucket ``key``: it reads the static inputs and returns (logits, nxt,
    fin, margin).
    ``chain_tok`` is the engine's (n_slots,) int32 device vector; it is
    only ever written in place."""

    def __init__(self, fn: Callable, chain_tok: torch.Tensor, on_capture: Callable[[], None]):
        if chain_tok.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.fn = fn
        self.chain_tok = chain_tok
        self.device = chain_tok.device
        self.on_capture = on_capture
        self.mem = torch.cuda.graph_pool_handle()
        self.buckets: dict[int, _Bucket] = {}
        self.replays = 0  # graph replays so far (a bucket's warm-up tick is not one)

    def node_count(self, key) -> int:
        """Nodes (kernels and copies) of bucket ``key``'s captured graph
        (``cuGraphGetNodes`` of libcuda)."""
        import ctypes

        n = ctypes.c_size_t(0)
        handle = ctypes.c_void_p(self.buckets[key].graph.raw_cuda_graph())
        rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(handle, None, ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
        return n.value

    def packed_input(self, key, cols: int) -> torch.Tensor:
        """The static packed row (n_slots, ``cols``) of bucket ``key``, to be
        filled before ``run(key)``."""
        b = self.buckets.get(key)
        if b is None:
            n = self.chain_tok.shape[0]
            b = self.buckets[key] = _Bucket(
                key, torch.zeros((n, cols), dtype=torch.int32, device=self.device))
        return b.packed

    def run(self, key) -> tuple:
        """The decode step of bucket ``key`` on its static inputs: one
        replay, or on the bucket's first tick the warm-up and capture."""
        b = self.buckets[key]
        if b.graph is None:
            return self._capture(b)
        b.graph.replay()
        self.replays += 1
        for name, n in b.deltas.items():
            build.counter(name).count += n
        return b.outputs

    def _capture(self, b: _Bucket) -> tuple:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs = self.fn(b.key, b.packed, self.chain_tok)  # this tick, eagerly
        cur.wait_stream(side)
        for t in outs:
            t.record_stream(cur)
        before = build.counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph, pool=self.mem):
                b.outputs = self.fn(b.key, b.packed, self.chain_tok)
        finally:
            after = build.counts()
            for name, c in build.COUNTERS.items():  # a capture launches nothing
                c.count = before.get(name, 0)
        b.deltas = {n: k - before.get(n, 0) for n, k in after.items() if k != before.get(n, 0)}
        b.graph = graph
        self.on_capture()
        return outs
