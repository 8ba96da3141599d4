"""Timing and profiling.

(reference: per-kernel wall-clock accumulators inside the solver struct,
ecg.h:87-98 tot/comm/trsm/gemm/... sampled around every MKL call, plus
min/max/avg across ranks via preAlps_dstats_display, preAlps_utils.c:720.)

Device code is fully fused under jit, so per-kernel host timers
are meaningless inside the loop; instead we provide (1) host-phase timers for
setup/build/solve stages, (2) jax.profiler trace capture around solves
(named scopes mark the solver phases), and (3) per-iteration cost derived
from the on-device residual history length.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import jax


@dataclass
class Timers:
    """Accumulating host-side phase timers (the ECGPrint analog)."""

    acc: dict = field(default_factory=lambda: defaultdict(float))
    count: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> str:
        lines = ["=== Timings ==="]
        for name in sorted(self.acc):
            lines.append(
                f"  {name:<20s} {self.acc[name]:10.4f} s  (x{self.count[name]})"
            )
        return "\n".join(lines)

    def as_dict(self):
        return dict(self.acc)


@contextlib.contextmanager
def timed(timers: Timers | None, name: str):
    if timers is None:
        yield
    else:
        with timers.time(name):
            yield


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Capture a jax.profiler trace around a block (view with TensorBoard /
    xprof). No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def scope(name: str):
    """Named profiler scope decorator for jitted phases."""
    return jax.named_scope(name)
