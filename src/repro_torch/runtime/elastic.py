"""Straggler watchdog (counterpart of the ``HostBeat`` / ``Watchdog`` part
of ``repro/runtime/elastic.py``).

``Watchdog`` is the host-level straggler detector: heartbeat timestamps
per host, flagging hosts whose step time exceeds ``slack`` × the median
and hosts that have not beaten within a timeout.  On a real cluster the
action is to evict and restart elastically; a one-card run exercises
detection only.  The reference's ``derive_mesh`` (the elastic mesh over
whatever devices survive) waits for the port's multi-device item.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import numpy as np


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
