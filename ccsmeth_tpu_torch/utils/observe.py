"""Observability: per-stage throughput counters and a profiler trace.

``ThroughputMeter`` is a copy of ``ccsmeth_tpu/utils/observe.py``'s;
``device_trace`` is the counterpart of its ``jax.profiler`` trace
(``observe.py:47-60``): a ``torch.profiler`` trace of the host and, on a
CUDA device, of the card, written as a Chrome trace (chrome://tracing or
Perfetto) into the directory.
"""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device=None):
    """torch.profiler trace context: CPU activity, plus CUDA when ``device``
    is a CUDA device; on exit the trace is written to
    ``trace_dir/trace_<pid>_<time ns>.json``, one file a trace, as
    jax.profiler writes one timestamped run a trace. A no-op when trace_dir
    is None."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace_{}_{}.json".format(os.getpid(), time.time_ns()))
    LOGGER.info("torch profiler trace -> %s", trace_dir)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    LOGGER.info("torch profiler trace saved to %s", path)
