"""Three-term roofline of a dry-run trace on an NVIDIA H100 (counterpart
of ``repro/launch/roofline.py``, whose hardware model is a TPU v5e and
whose counts come from XLA's ``cost_analysis``):

  compute    = Σ_unit FLOPs_unit / peak_unit       (per device)
  memory     = HBM bytes / HBM bandwidth           (per device)
  collective = Σ_group collective bytes / the group's link bandwidth

The counts come from running the step on meta tensors under ``trace``:

* FLOPs: ``torch.utils.flop_counter``'s formulas for every matmul-like
  aten op (attributed to the unit of its input dtype: bf16 and fp16 on
  the bf16 tensor cores, f32 on the CUDA cores — TF32 is off in the port),
  plus the hand-written kernels' counts by unit (``kernels/build.py``'s
  meta count: int8 tensor-core products, f32 encodes);
* HBM bytes: the input and output bytes of every aten op, unfused — an
  upper bound on what a fused program moves — plus the kernels' bytes;
* collective bytes: ``launch/mesh.py``'s counter, by kind and group.

Hardware model: H100 SXM, the NVIDIA data sheet's dense peaks — figures
of the data sheet, not measurements: bf16 989 TFLOP/s and int8 1,979
TOP/s on the tensor cores, f32 67 TFLOP/s on the CUDA cores, HBM3 3.35
TB/s; NVLink 4 at 450 GB/s a direction per GPU inside a node of 8, and
50 GB/s a GPU across nodes (400 Gb/s NDR).  A group whose ranks span
nodes is priced at the slower link.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAKS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_FLOPS = PEAKS["bf16"]  # the roofline fraction's reference peak
HBM_BW = 3.35e12
HBM_BYTES = 80e9  # an H100 80GB's device memory
NVLINK_BW = 450e9
NET_BW = 50e9
GPUS_PER_NODE = 8


def link_bw(ranks) -> float:
    """The bandwidth a group's collectives run at: NVLink inside one node,
    the network once its ranks span nodes."""
    return NVLINK_BW if len({r // GPUS_PER_NODE for r in ranks}) <= 1 else NET_BW


@dataclasses.dataclass
class Roofline:
    flops: float  # per device
    hbm_bytes: float  # per device
    coll_bytes: float  # per device
    coll_breakdown: dict
    model_flops: float  # analytic useful FLOPs per device
    peak_mem_bytes: float
    flops_by_unit: dict  # unit → FLOPs per device
    coll_s: float  # Σ over the groups of their bytes over their link's bandwidth

    @property
    def t_compute(self) -> float:
        return sum(n / PEAKS[u] for u, n in self.flops_by_unit.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_s

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the peak-FLOPs roofline the bound-term step achieves
        on *useful* model FLOPs: (model_flops/peak) / t_bound."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.t_bound

    def row(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_per_dev": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_gib": self.peak_mem_bytes / 2**30,
            "coll_breakdown": self.coll_breakdown,
            "flops_by_unit": self.flops_by_unit,
        }


# ----------------------------------------------------------- the trace
_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "_local_scalar_dense")


def _unit(args) -> str:
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            if t.dtype in (torch.bfloat16, torch.float16):
                return "bf16"
            if t.dtype in (torch.int8, torch.uint8):
                return "int8"
            return "f32"
    return "f32"


class _Trace(TorchDispatchMode):
    """FLOPs by unit, bytes in and out of every op, and the peak of the
    bytes the ops' outputs hold alive (each new storage from its first
    output until that tensor is freed)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = {}
        self.bytes = 0.0
        self.live = {}
        self.live_bytes = 0
        self.peak = 0

    def _free(self, key):
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            n = self.registry[packet](*args, **kwargs, out_val=out)
            unit = _unit(args)
            self.flops[unit] = self.flops.get(unit, 0) + n
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        view = getattr(func, "is_view", False)
        if not view and packet.__name__ not in _NO_TRAFFIC:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if not view:
            for t in outs:
                key = t.untyped_storage()._cdata
                if key not in self.live:
                    self.live[key] = t.untyped_storage().nbytes()
                    self.live_bytes += self.live[key]
                    weakref.finalize(t, self._free, key)
            self.peak = max(self.peak, self.live_bytes)
        return out


@dataclasses.dataclass
class Trace:
    """What ``trace`` recorded: aten FLOPs by unit and bytes, the peak of
    live bytes the traced ops made, the kernels' meta counts and the
    collectives' bytes."""

    flops: dict
    bytes: float
    peak_live: float
    kernels: dict
    collectives: dict


@contextlib.contextmanager
def trace():
    """Record the work of the body (run it on meta tensors): yields a
    ``Trace`` filled in when the body ends."""
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib

    build.reset_meta_cost()
    mesh_lib.reset_collective_bytes()
    rec = Trace({}, 0.0, 0.0, {}, {})
    mode = _Trace()
    with mode:
        yield rec
    rec.flops, rec.bytes, rec.peak_live = dict(mode.flops), mode.bytes, float(mode.peak)
    rec.kernels = build.meta_cost()
    rec.collectives = mesh_lib.collective_bytes()


def analyse(tr: Trace, model_flops_per_dev: float, resident_bytes: float = 0.0) -> Roofline:
    """The roofline of a recorded step; ``resident_bytes``: what the step's
    inputs hold on the device (params, optimizer state, batch, caches),
    added to the trace's peak of live bytes."""
    by_unit = {u: float(n) for u, n in tr.flops.items()}
    hbm = tr.bytes
    for row in tr.kernels.values():
        hbm += row["bytes"]
        for u in PEAKS:
            if row[u]:
                by_unit[u] = by_unit.get(u, 0.0) + row[u]
    coll: dict = {}
    coll_s = 0.0
    for (kind, ranks), n in tr.collectives.items():
        coll[kind] = coll.get(kind, 0.0) + n
        coll_s += n / link_bw(ranks)
    return Roofline(
        flops=sum(by_unit.values()),
        hbm_bytes=hbm,
        coll_bytes=sum(coll.values()),
        coll_breakdown=coll,
        model_flops=model_flops_per_dev,
        peak_mem_bytes=resident_bytes + tr.peak_live,
        flops_by_unit=by_unit,
        coll_s=coll_s,
    )


def model_flops(cfg, shape, n_chips: int) -> float:
    """Analytic useful FLOPs per device: 6·N_active·tokens (train),
    2·N_active·tokens (+attention) for inference."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n_active * tokens
    # attention score/value FLOPs (quadratic part), forward only
    if cfg.family in ("dense", "moe", "vlm"):
        att_tok = shape.seq_len if shape.kind != "decode" else shape.seq_len  # kv len
        q_tok = shape.seq_len if shape.kind != "decode" else 1
        causal = 0.5 if shape.kind != "decode" else 1.0
        a = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * q_tok * att_tok * causal * shape.global_batch
        flops += a * (3.0 if shape.kind == "train" else 1.0)
    return flops / n_chips
