"""Profiling/tracing helpers.

The reference's only performance visibility is scraping the C++ engine's
console lines (SURVEY §5). Here: first-class ``jax.profiler`` traces plus
per-run Mcells/s accounting (already attached to every solver result).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import time
from collections import Counter
from pathlib import Path
from typing import Iterator, List, Tuple


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/fdtd_trace") -> Iterator[str]:
    """Capture a jax.profiler trace of the enclosed block.

    Usage::

        with trace("/tmp/mytrace"):
            sim.run()
    """
    import jax
    import jax.profiler

    with jax.profiler.trace(log_dir):
        yield log_dir


def summarize_trace(log_dir: str, top: int = 20) -> List[Tuple[str, float, int]]:
    """Aggregate device-op durations from the newest trace under ``log_dir``.

    Returns [(op_name, total_seconds, count)] sorted by total time — enough
    to find the hot op without TensorBoard.
    """
    files = sorted(
        glob.glob(str(Path(log_dir) / "plugins/profile/*/*.trace.json.gz"))
    )
    if not files:
        raise FileNotFoundError(f"no trace files under {log_dir}")
    with gzip.open(files[-1]) as fh:
        data = json.load(fh)
    agg: Counter = Counter()
    cnt: Counter = Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        name = e.get("name", "?")
        agg[name] += e.get("dur", 0)
        cnt[name] += 1
    return [
        (name, dur / 1e6, cnt[name]) for name, dur in agg.most_common(top)
    ]


class StepTimer:
    """Rolling wall-clock → Mcells/s reporter for custom loops."""

    def __init__(self, num_cells: int):
        self.num_cells = num_cells
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, steps: int = 1) -> None:
        self._steps += steps

    @property
    def mcells_per_s(self) -> float:
        dt = max(time.perf_counter() - self._t0, 1e-12)
        return self.num_cells * self._steps / dt / 1e6
