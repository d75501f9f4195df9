"""Deterministic fault injection, the port's copy of
``tpu_bootstrap/workload/faults.py`` (the same ``TPUBC_FAULT`` grammar,
sites and firing schedule; the port imports nothing of the JAX package).

    TPUBC_FAULT="site[:prob][:after_n][:seed],..."

- ``site``     one of :data:`SITES`; unknown names fail at parse time.
- ``prob``     omitted or ``1``: the rule fires exactly once, on call
               ``after_n + 1`` to that site. ``prob < 1``: every call after
               ``after_n`` fires independently with that probability from a
               seeded stream.
- ``after_n``  calls to skip before the rule arms (default 0).
- ``seed``     the per-rule RNG seed for ``prob < 1`` rules (default 0).

Repeating a site makes a multi-shot schedule. With ``TPUBC_FAULT`` unset,
:func:`fire` is one global check. Tests drive the injector through
:func:`install`. The port's seams so far: ``ckpt.save``, ``pool.device`` and
``swap.xfer``.
"""

from __future__ import annotations

import os
import random
import threading

from tpu_bootstrap_torch import telemetry

FAULT_ENV = "TPUBC_FAULT"

# The reference's named seams (every one parses; the port fires those of
# its ported paths).
SITES = ("pool.device", "alloc", "sched.admit", "ingress.write",
         "ckpt.save", "scrape", "swap.xfer", "router.dispatch",
         "router.scrape", "sim.dispatch")


class InjectedFault(RuntimeError):
    """A scheduled failure; carries the site and the 1-based call count at
    which it fired."""

    def __init__(self, site: str, count: int):
        super().__init__(f"injected fault at {site} (call #{count})")
        self.site = site
        self.count = count


class _Rule:
    __slots__ = ("site", "prob", "after_n", "seed", "_rng")

    def __init__(self, site: str, prob: float, after_n: int, seed: int):
        self.site = site
        self.prob = prob
        self.after_n = after_n
        self.seed = seed
        self._rng = random.Random(seed)

    def should_fire(self, count: int) -> bool:
        if count <= self.after_n:
            return False
        if self.prob >= 1.0:
            return count == self.after_n + 1  # one-shot
        return self._rng.random() < self.prob


class FaultInjector:
    """Parsed schedule + per-site call counters."""

    def __init__(self, spec: str):
        self._lock = threading.Lock()
        self._rules: dict[str, list[_Rule]] = {}
        self._calls: dict[str, int] = {}  # guarded-by: _lock
        self._fired: dict[str, int] = {}  # guarded-by: _lock
        self.spec = spec
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            site = fields[0]
            if site not in SITES:
                raise ValueError(
                    f"TPUBC_FAULT: unknown site {site!r} (known: "
                    f"{', '.join(SITES)})")
            prob = float(fields[1]) if len(fields) > 1 and fields[1] else 1.0
            if not 0.0 <= prob <= 1.0:
                raise ValueError(f"TPUBC_FAULT: prob {prob} outside [0, 1]")
            after_n = int(fields[2]) if len(fields) > 2 and fields[2] else 0
            seed = int(fields[3]) if len(fields) > 3 and fields[3] else 0
            self._rules.setdefault(site, []).append(
                _Rule(site, prob, after_n, seed))

    def fire(self, site: str) -> None:
        rules = self._rules.get(site)
        if not rules:
            return
        with self._lock:
            count = self._calls.get(site, 0) + 1
            self._calls[site] = count
            hit = any(r.should_fire(count) for r in rules)
            if hit:
                self._fired[site] = self._fired.get(site, 0) + 1
        if hit:
            # The reference's labelled series, keyed as its JSON renders it.
            telemetry.metrics().inc(f'fault_injected_total{{site="{site}"}}')
            raise InjectedFault(site, count)

    def stats(self) -> dict:
        with self._lock:
            return {"spec": self.spec, "calls": dict(self._calls),
                    "fired": dict(self._fired)}


_ACTIVE = False
_INJECTOR: FaultInjector | None = None


def install(spec: str | None) -> FaultInjector | None:
    """(Re)configure the process-wide injector; ``None``/empty disables
    it. Returns the injector so tests can read ``stats()``."""
    global _ACTIVE, _INJECTOR
    inj = FaultInjector(spec) if spec else None
    _INJECTOR = inj
    _ACTIVE = inj is not None
    return inj


def active() -> bool:
    return _ACTIVE


def fire(site: str) -> None:
    """Raise :class:`InjectedFault` if the schedule says this call to
    ``site`` fails."""
    if not _ACTIVE:
        return
    _INJECTOR.fire(site)


install(os.environ.get(FAULT_ENV))
