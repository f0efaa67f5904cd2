"""Deterministic fault injection for the paged serving engine (a copy of
``repro/serving/faults.py``: every decision is byte-equal to the
reference's for the same ``(seed, site, tick, key)``).

Chaos testing only earns its keep when every failure it provokes is
**reproducible**: a run that fails on seed 7 must fail the same way on
every machine and every rerun, however often each injection site is
consulted.  So the injector draws nothing from shared mutable RNG state:
every decision is a pure function of ``(seed, site, tick, key)``, hashed
through blake2b like the prefix cache's chain hashes.  Two engines
replaying the same tick/site/key sequence see the same faults; consulting
a site twice does not move the next site's roll.

Sites (the engine's seams, see ``PagedEngine``):

* ``"alloc"``        — ``_alloc_page`` pretends the pool is dry (one
                       query): eviction, preemption and mid-admission
                       exhaustion;
* ``"prefix_claim"`` — a planned prefix-hit chain is dropped (as if a
                       racing eviction took the pages), forcing the
                       recompute path;
* ``"launch"``       — the next launch is delayed by ``delay_s`` on the
                       host (deadline / stall-guard pressure);
* ``"logits"``       — the host copy of one slot's finite flag reads
                       false (what a non-finite W4A4 activation does),
                       which the NaN guard must quarantine;
* ``"sampler"``      — the token pick of one slot raises
                       ``InjectedFault``;
* ``"swap_out"``     — a host-tier swap-out is refused (a parked page's
                       demotion: plain eviction; a preemption carry:
                       recompute);
* ``"swap_in"``      — a host-tier swap-in is refused (the entry is
                       dropped: the chunk or the request recomputes);
* ``"swap_corrupt"`` — a stored byte of the entry is flipped before its
                       swap-in's integrity check, which must quarantine
                       only the owning request.

Faults fire two ways: an explicit ``schedule`` of ``(tick, site)`` /
``(tick, site, key)`` points, and/or a ``rates`` dict of per-site
probabilities evaluated by the deterministic hash roll.  ``max_faults``
bounds the total so a chaos run always ends.  Every fault that fires is
recorded in ``log`` and summarized by ``summary()`` for the chaos report
(``tools/check_chaos.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Iterable, Optional

SITES = ("alloc", "prefix_claim", "launch", "logits", "sampler",
         "swap_out", "swap_in", "swap_corrupt")


class InjectedFault(RuntimeError):
    """An exception the injector raised on purpose (never a real bug —
    containment tests assert these are quarantined, strict mode
    re-raises them)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault that actually fired."""

    tick: int
    site: str
    key: int


class FaultInjector:
    """Seeded, order-independent fault source.

    ``fire(site, tick, key)`` returns True when a fault is injected at
    that point; the decision is a pure function of
    ``(seed, site, tick, key)`` plus the explicit schedule, so replaying
    a run reproduces its faults bit-for-bit.  ``key`` disambiguates
    multiple queries of one site within a tick (slot index, allocation
    ordinal) — pass the most stable identifier available.
    """

    def __init__(
        self,
        seed: int = 0,
        rates: Optional[dict] = None,
        schedule: Optional[Iterable[tuple]] = None,
        delay_s: float = 0.002,
        max_faults: Optional[int] = None,
    ):
        self.seed = int(seed)
        self.rates = dict(rates or {})
        for site in self.rates:
            assert site in SITES, f"unknown fault site {site!r} (know {SITES})"
        # schedule entries: (tick, site) fires for every key that tick;
        # (tick, site, key) fires for exactly that query
        self.schedule: set[tuple] = set()
        for ent in schedule or ():
            assert ent[1] in SITES, f"unknown fault site {ent[1]!r}"
            self.schedule.add(tuple(ent))
        self.delay_s = delay_s
        self.max_faults = max_faults
        self.log: list[FaultEvent] = []
        self._alloc_ordinal = 0  # per-engine-lifetime alloc query counter

    # ------------------------------------------------------------- rolls
    def _roll(self, site: str, tick: int, key: int) -> float:
        """Uniform [0, 1) as a pure function of (seed, site, tick, key)."""
        h = hashlib.blake2b(
            f"{self.seed}:{site}:{tick}:{key}".encode(), digest_size=8
        )
        return int.from_bytes(h.digest(), "little") / 2.0**64

    def fire(self, site: str, tick: int, key: int = 0) -> bool:
        assert site in SITES, f"unknown fault site {site!r}"
        if self.max_faults is not None and len(self.log) >= self.max_faults:
            return False
        hit = (
            (tick, site) in self.schedule
            or (tick, site, key) in self.schedule
            or self._roll(site, tick, key) < self.rates.get(site, 0.0)
        )
        if hit:
            self.log.append(FaultEvent(tick=tick, site=site, key=key))
        return hit

    # ------------------------------------------------------ site helpers
    def alloc_fails(self, tick: int) -> bool:
        """One allocator query: pretend the free list is empty.  Keyed by
        a monotone ordinal so a retry after a preemption re-rolls (a
        'flake' is transient by construction, not sticky)."""
        self._alloc_ordinal += 1
        return self.fire("alloc", tick, self._alloc_ordinal)

    def drop_prefix_claim(self, tick: int, key: int = 0) -> bool:
        return self.fire("prefix_claim", tick, key)

    def delay_launch(self, tick: int, key: int = 0) -> None:
        """Host-side sleep before a launch (deadline/stall pressure)."""
        if self.fire("launch", tick, key):
            time.sleep(self.delay_s)

    def poison_logits(self, tick: int, slot: int) -> bool:
        return self.fire("logits", tick, slot)

    def sampler_raises(self, tick: int, slot: int) -> None:
        if self.fire("sampler", tick, slot):
            raise InjectedFault(
                f"injected sampler fault (tick={tick}, slot={slot})"
            )

    def swap_out_fails(self, tick: int, key: int = 0) -> bool:
        """One host-tier swap-out attempt fails (fall back to plain
        eviction / recompute preemption).  Keyed by the evicted pid."""
        return self.fire("swap_out", tick, key)

    def swap_in_fails(self, tick: int, key: int = 0) -> bool:
        """One host-tier swap-in attempt fails (entry unusable — fall
        back to recompute).  Keyed by the host handle."""
        return self.fire("swap_in", tick, key)

    def swap_corrupts(self, tick: int, key: int = 0) -> bool:
        """Flip a stored byte before this swap-in's integrity check, so
        verification raises ``PageCorruptionError``.  Keyed by the host
        handle."""
        return self.fire("swap_corrupt", tick, key)

    # ---------------------------------------------------------- reporting
    def counts(self) -> dict:
        out: dict[str, int] = {}
        for ev in self.log:
            out[ev.site] = out.get(ev.site, 0) + 1
        return out

    def summary(self) -> dict:
        """JSON-able record for the chaos-report artifact."""
        return {
            "seed": self.seed,
            "rates": dict(self.rates),
            "scheduled": sorted(
                [list(e) for e in self.schedule], key=lambda e: (e[0], e[1])
            ),
            "total": len(self.log),
            "by_site": self.counts(),
            "events": [
                {"tick": ev.tick, "site": ev.site, "key": ev.key}
                for ev in self.log[:256]  # bounded detail
            ],
        }
