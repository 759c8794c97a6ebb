"""Process-level setup helpers for entry points."""

from __future__ import annotations

import os
from pathlib import Path

# fixed default beside the package checkout: the cache key includes the
# directory, so a path that moved between runs would never hit
DEFAULT_COMPILE_CACHE_DIR = str(
    Path(__file__).resolve().parents[2] / ".jax_cache")


def disable_numpy_hugepage_stalls() -> None:
    """Stop NumPy from madvising MADV_HUGEPAGE on large allocations.

    NumPy ≥1.18 tags every ≥4 MB allocation with ``madvise(MADV_HUGEPAGE)``.
    On hosts where transparent-huge-page defrag is synchronous (``defrag =
    [madvise]``), the first write to each such allocation stalls in kernel
    page-compaction: measured at ~85 ms/MB — a fresh 34 MB float64
    temporary costs ~3 s to first-touch, versus 20 ms without the madvise.
    ``prepare`` for a 4.2M-cell scene allocates gigabytes of NumPy
    temporaries (voxel masks, edge averages, Ca/Cb builds), so these stalls
    dominated its wall clock. Host-side THP gives no measurable win for
    this workload — the hot loops stream once over each array — so turn
    the madvise off process-wide at package import. Honors an explicit
    user override via the standard ``NUMPY_MADVISE_HUGEPAGE`` env var.
    """
    if os.environ.get("NUMPY_MADVISE_HUGEPAGE"):
        return  # user explicitly chose a policy; respect it
    try:
        from numpy._core import multiarray as _ma

        _ma._set_madvise_hugepage(False)
    except (ImportError, AttributeError):
        pass  # private API; absence just means slower prepare, not failure


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set, else
    the fixed :data:`DEFAULT_COMPILE_CACHE_DIR`. Every entry point that
    compiles for the device calls this before its first compile.
    """
    import jax

    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or DEFAULT_COMPILE_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    return path
