"""Named-timer registry + JAX profiler hooks (reference C12 equivalent).

Host-side re-design of the reference ``timing::`` registry
(/root/reference/include/mav_tube_trajectory_generation/timing.h:36-214,
src/timing.cpp): RAII-style named timers accumulating into a global
singleton with a rolling window (sum/mean/min/max/stddev), a printable
report, and a compile-out dummy -- plus what the reference cannot have:
``trace`` wraps a block in a ``jax.profiler`` TraceAnnotation so sections
show up on the device timeline, and ``time_jax`` blocks on device results so
asynchronous dispatch doesn't fake timings.
"""

from __future__ import annotations

import collections
import math
import time
from contextlib import contextmanager
from typing import Dict, Optional

import jax

WINDOW = 50  # rolling-window length, matching Accumulator<.,.,50>


class Accumulator:
    """Rolling-window statistics (timing.h:36-101)."""

    def __init__(self, window: int = WINDOW):
        self.window = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def add(self, value: float) -> None:
        self.window.append(value)
        self.total += value
        self.count += 1
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def rolling_mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    @property
    def std(self) -> float:
        n = len(self.window)
        if n < 2:
            return 0.0
        m = self.rolling_mean
        return math.sqrt(sum((v - m) ** 2 for v in self.window) / (n - 1))


class Timing:
    """Global registry (timing.h:141-181)."""

    _timers: Dict[str, Accumulator] = {}
    enabled: bool = True

    @classmethod
    def add(cls, tag: str, seconds: float) -> None:
        if not cls.enabled:
            return
        cls._timers.setdefault(tag, Accumulator()).add(seconds)

    @classmethod
    def get(cls, tag: str) -> Optional[Accumulator]:
        return cls._timers.get(tag)

    @classmethod
    def get_mean(cls, tag: str) -> float:
        acc = cls._timers.get(tag)
        return acc.mean if acc else 0.0

    @classmethod
    def get_total(cls, tag: str) -> float:
        acc = cls._timers.get(tag)
        return acc.total if acc else 0.0

    @classmethod
    def get_num_samples(cls, tag: str) -> int:
        acc = cls._timers.get(tag)
        return acc.count if acc else 0

    @classmethod
    def reset(cls) -> None:
        cls._timers.clear()

    @classmethod
    def print(cls) -> str:
        """Formatted report (timing.cpp:159-193 analogue)."""
        lines = ["Timing", "-" * 72,
                 f"{'tag':30s} {'n':>6s} {'total':>9s} {'mean':>9s} "
                 f"{'std':>8s} {'min':>8s} {'max':>8s}"]
        for tag in sorted(cls._timers):
            a = cls._timers[tag]
            lines.append(
                f"{tag:30s} {a.count:6d} {a.total:9.4f} {a.mean:9.5f} "
                f"{a.std:8.5f} {a.min:8.5f} {a.max:8.5f}")
        return "\n".join(lines)


class Timer:
    """RAII/context-manager timer (timing.h:124-139).

    Usage::

        with Timer("opti/deriv"):
            ...
    """

    def __init__(self, tag: str, construct_stopped: bool = False):
        self.tag = tag
        self._start: Optional[float] = None
        if not construct_stopped:
            self.start()

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            return 0.0
        dt = time.perf_counter() - self._start
        Timing.add(self.tag, dt)
        self._start = None
        return dt

    def is_timing(self) -> bool:
        return self._start is not None

    def __enter__(self):
        if self._start is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class DummyTimer:
    """Compile-out variant (timing.h:113-122)."""

    def __init__(self, *a, **k): pass
    def start(self): pass
    def stop(self): return 0.0
    def is_timing(self): return False
    def __enter__(self): return self
    def __exit__(self, *exc): return False


@contextmanager
def trace(tag: str):
    """Named section on both the host registry and the JAX profiler
    timeline."""
    with jax.profiler.TraceAnnotation(tag):
        with Timer(tag):
            yield


def time_jax(tag: str, fn, *args, **kwargs):
    """Time a JAX computation correctly: blocks on the device result so
    asynchronous dispatch is included (the on-device analogue of the
    reference's wall-clock timers around solve calls)."""
    t = Timer(tag)
    out = fn(*args, **kwargs)
    out = jax.block_until_ready(out)
    t.stop()
    return out
