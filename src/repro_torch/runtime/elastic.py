"""Elastic mesh derivation and the straggler watchdog (counterpart of
``repro/runtime/elastic.py``).

``derive_mesh`` builds the best (data, model[, pod]) mesh for whatever
rank count survives a failure: model parallelism is capped by what the
count divides, the rest goes to data.  Checkpoints are rank-count
agnostic (checkpoint/manager.py), so the recovery story is: a node dies →
the job restarts on N' ranks → ``derive_mesh`` → restore the latest
checkpoint → the train step lays the state out by the new mesh's specs →
training continues (the data pipeline is (seed, step)-pure, so no data is
lost or repeated).

``Watchdog`` is the host-level straggler detector: heartbeat timestamps
per host, flagging hosts whose step time exceeds ``slack`` × the median
and hosts that have not beaten within a timeout.  On a real cluster the
action is to evict and restart elastically; a one-card run exercises
detection only.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import numpy as np


def derive_mesh(n_devices: int | None = None, model_parallel: int = 16, multi_pod: bool = False,
                pod_size: int = 256):
    """Best-effort mesh for an arbitrary rank count: the world's ranks, or
    its first ``n_devices`` (``launch.mesh.init_group`` first)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    n = dist.get_world_size() if n_devices is None else n_devices
    if multi_pod and n > pod_size and n % pod_size == 0:
        pods = n // pod_size
        mp = min(model_parallel, pod_size)
        return make_mesh((pods, pod_size // mp, mp), ("pod", "data", "model"), range(n))
    mp = model_parallel
    while mp > 1 and n % mp:
        mp //= 2
    return make_mesh((n // mp, mp), ("data", "model"), range(n))


@dataclasses.dataclass
class HostBeat:
    step: int
    t: float


class Watchdog:
    """Straggler detection from per-host heartbeats."""

    def __init__(self, n_hosts: int, slack: float = 3.0, min_samples: int = 3):
        self.n_hosts = n_hosts
        self.slack = slack
        self.min_samples = min_samples
        self._beats: dict[int, list[HostBeat]] = defaultdict(list)

    def beat(self, host: int, step: int, t: float | None = None):
        self._beats[host].append(HostBeat(step, time.monotonic() if t is None else t))

    def step_times(self) -> dict[int, float]:
        """Each host's median step time over its last 8 intervals."""
        out = {}
        for h, beats in self._beats.items():
            if len(beats) >= 2:
                dts = [b2.t - b1.t for b1, b2 in zip(beats, beats[1:])]
                out[h] = float(np.median(dts[-8:]))
        return out

    def stragglers(self) -> list[int]:
        times = self.step_times()
        if len(times) < self.min_samples:
            return []
        med = float(np.median(list(times.values())))
        return [h for h, t in times.items() if t > self.slack * med]

    def missing(self, timeout: float, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        out = []
        for h in range(self.n_hosts):
            beats = self._beats.get(h)
            if not beats or now - beats[-1].t > timeout:
                out.append(h)
        return out
