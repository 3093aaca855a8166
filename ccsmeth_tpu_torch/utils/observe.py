"""Observability: per-stage throughput counters.

Copy of ThroughputMeter from ``ccsmeth_tpu/utils/observe.py``; the device trace
(``--profile_dir``) is not ported yet.
"""

from __future__ import annotations

import time

from .logging import mylogger

LOGGER = mylogger(__name__)


class ThroughputMeter:
    """Counts named events and logs rates every ``interval`` seconds."""

    def __init__(self, name: str, interval: float = 30.0):
        self.name = name
        self.interval = interval
        self.t0 = time.time()
        self._last = self.t0
        self.counts: dict[str, int] = {}

    def add(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n
        now = time.time()
        if now - self._last >= self.interval:
            self._last = now
            self.log()

    def rate(self, key: str) -> float:
        dt = time.time() - self.t0
        return self.counts.get(key, 0) / dt if dt > 0 else 0.0

    def log(self) -> None:
        dt = time.time() - self.t0
        parts = ["{}={} ({:.1f}/s)".format(k, v, v / dt if dt > 0 else 0.0)
                 for k, v in sorted(self.counts.items())]
        LOGGER.info("[%s] %s, elapsed %.1fs", self.name, ", ".join(parts), dt)
