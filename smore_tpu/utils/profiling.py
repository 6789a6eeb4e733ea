"""Profiling / tracing helpers.

The reference has none (SURVEY.md 5.1) -- only a progress printf every
10k samples. Here:
  - ``phase_timer``: wall-clock metering per named phase, with a report.
  - ``trace``: context manager around jax.profiler for device traces
    (view in TensorBoard / xprof).
  - ``throughput``: samples/sec helper used by the train drivers.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class PhaseTimer:
    """Accumulates wall time per phase name."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-12
        lines = ["phase                 total_s   calls   share"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<20} {t:8.3f} {self.counts[name]:7d} "
                f"{100 * t / total:6.1f}%"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (device HLO timeline) around a block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def throughput(n_samples: int, seconds: float) -> float:
    return n_samples / max(seconds, 1e-12)
