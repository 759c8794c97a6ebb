"""Patch-antenna simulation framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``Veeryan/FDTD-solver-antennas`` project (``antenna_sim`` package): analytical
cavity-model solver, Yee-grid FDTD engine (replacing the external openEMS C++
DLLs), microstrip/multi-patch scene solvers, port S-parameter and NF2FF
post-processing, plotting, and CLI/web frontends.

Public API mirrors the reference export surface
(``/root/reference/antenna_sim/__init__.py:1-57``) so users of the reference
find the same names here, while everything numeric runs on the JAX device
(an NVIDIA GPU, or the CPU).

The plotting helpers import matplotlib on first use only, so the engine
imports without it.
"""

from .utils.backend import disable_numpy_hugepage_stalls as _no_thp

_no_thp()  # see utils/backend.py: THP defrag stalls make prepare ~100x slower
del _no_thp

from .models.params import (
    Metal,
    MetalProperties,
    metal_defaults,
    PatchAntennaParams,
    HornAntennaParams,
)
from .solvers.analytical import AnalyticalPatchSolver, SolverResult
from .solvers.base import (
    SolverProbe,
    SolverPrepared,
    FDTDSolverResult,
    # Back-compat aliases matching the reference naming
    OpenEMSProbe,
    OpenEMSPrepared,
    OpenEMSResult,
)
from .solvers.patch_fixed import (
    probe_fdtd,
    prepare_patch_fixed,
    run_prepared_fixed,
    # Reference-parity aliases
    probe_openems_fixed,
    prepare_openems_patch_fixed,
    run_prepared_openems_fixed,
)
from .solvers.microstrip import (
    FeedDirection,
    calculate_microstrip_width,
    prepare_microstrip_patch,
    run_prepared_microstrip,
    probe_openems_microstrip,
    prepare_openems_microstrip_patch,
    run_prepared_openems_microstrip,
)
from .solvers.microstrip_3d import (
    prepare_microstrip_patch_3d,
    run_prepared_microstrip_3d,
    prepare_openems_microstrip_patch_3d,
    run_prepared_openems_microstrip_3d,
)
from .solvers.multi_patch_3d import (
    HornLike,
    PatchLike,
    prepare_multi_patch_3d,
    run_prepared_multi_patch_3d,
    prepare_openems_microstrip_multi_3d,
    run_prepared_openems_microstrip_multi_3d,
)
from .solvers.patch_legacy import (
    probe_openems,
    prepare_patch_legacy,
    run_prepared_legacy,
    prepare_openems_patch,
    run_prepared_openems,
)
from .solvers.patch_2d import (
    Prepared2D,
    OpenEMS2DPrepared,
    prepare_patch_2d,
    run_prepared_2d,
    prepare_openems_patch_2d,
)
from .solvers.horn import (
    prepare_horn,
    run_prepared_horn,
    te10_guide_wavelength,
)
from .solvers.sparams import SMatrixResult, compute_s_matrix
from .solvers.array_synth import (
    ArrayPattern,
    EmbeddedPatternSet,
    compute_embedded_patterns,
)

_PLOTTING_NAMES = (
    "plot_cross_sections",
    "plot_3d_pattern",
    "plot_3d_pattern_from_grid",
    "draw_patch_3d_geometry",
    "draw_patch_top_view",
    "draw_microstrip_patch_3d_geometry",
)


def __getattr__(name):
    if name in _PLOTTING_NAMES:
        from .viz import plotting

        return getattr(plotting, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = [
    # Domain models
    "PatchAntennaParams",
    "HornAntennaParams",
    "Metal",
    "MetalProperties",
    "metal_defaults",
    # Analytical solver
    "AnalyticalPatchSolver",
    "SolverResult",
    # FDTD solver protocol
    "SolverProbe",
    "SolverPrepared",
    "FDTDSolverResult",
    "OpenEMSProbe",
    "OpenEMSPrepared",
    "OpenEMSResult",
    # Fixed patch solver
    "probe_fdtd",
    "prepare_patch_fixed",
    "run_prepared_fixed",
    "probe_openems_fixed",
    "prepare_openems_patch_fixed",
    "run_prepared_openems_fixed",
    # Microstrip solvers
    "FeedDirection",
    "calculate_microstrip_width",
    "prepare_microstrip_patch",
    "run_prepared_microstrip",
    "probe_openems_microstrip",
    "prepare_openems_microstrip_patch",
    "run_prepared_openems_microstrip",
    "prepare_microstrip_patch_3d",
    "run_prepared_microstrip_3d",
    "prepare_openems_microstrip_patch_3d",
    "run_prepared_openems_microstrip_3d",
    # Multi-patch solver
    "HornLike",
    "PatchLike",
    "prepare_multi_patch_3d",
    "run_prepared_multi_patch_3d",
    "prepare_openems_microstrip_multi_3d",
    "run_prepared_openems_microstrip_multi_3d",
    # Legacy full-sphere solver
    "probe_openems",
    "prepare_patch_legacy",
    "run_prepared_legacy",
    "prepare_openems_patch",
    "run_prepared_openems",
    # Horn solver (beyond-reference capability)
    "prepare_horn",
    "run_prepared_horn",
    "te10_guide_wavelength",
    # N-port S-matrix extraction (beyond-reference capability)
    "SMatrixResult",
    "compute_s_matrix",
    # Embedded element patterns + array synthesis (beyond-reference)
    "ArrayPattern",
    "EmbeddedPatternSet",
    "compute_embedded_patterns",
    # Quasi-2D solver
    "Prepared2D",
    "OpenEMS2DPrepared",
    "prepare_patch_2d",
    "run_prepared_2d",
    "prepare_openems_patch_2d",
    # Plotting
    "plot_cross_sections",
    "plot_3d_pattern",
    "plot_3d_pattern_from_grid",
    "draw_patch_3d_geometry",
    "draw_patch_top_view",
    "draw_microstrip_patch_3d_geometry",
]
