"""Profiling/tracing hooks (the reference has none — SURVEY.md §5; here:
``jax.profiler`` traces + per-step wall-clock timing)."""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Optional

import jax


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a jax.profiler trace (TensorBoard-viewable) when log_dir set."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def card_name_and_power() -> str:
    """The first GPU's name and power limit as ``nvidia-smi`` reports them;
    a card set below its maximum limit runs slower under load, so every
    device number is kept beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class StepTimer:
    """Rolling per-step timing with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        return False

    @property
    def mean(self) -> float:
        n = self.count - self.warmup
        return self.total / n if n > 0 else float("nan")

    @property
    def steps_per_sec(self) -> float:
        m = self.mean
        return 1.0 / m if m and m == m and m > 0 else 0.0
