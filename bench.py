"""Benchmark: Yee cell-update rates on one GPU.

Prints one JSON line per metric; every line names the device it ran on
(JAX platform, ``device_kind``, device count, and the card's name and
power limit from ``nvidia-smi``). It refuses to run without a GPU, and a
failing cell fails the run.

1. ``yee_cell_updates_canonical_patch`` — the canonical 2.45 GHz FR-4 patch
   (the reference's fixed-solver workload: NrTS 30000, EndCriteria 1e-4,
   MUR walls, λ/20 mesh).
2. ``prepare_large_scene_s`` and ``yee_cell_updates_large_mixed_scene`` —
   the 4.2M-cell mixed patch+horn scene (examples/mixed_patch_horn.py
   geometry, z = 152).
3. ``yee_cell_updates_pml_patch`` — the canonical patch with PML_8 walls
   (the reference legacy solver's boundary, ``solver_fdtd_openems.py:188``).
4. ``yee_cell_updates_tall_patch_z160`` — a patch scene on a z=160 grid.
5. ``yee_cell_updates_geometry_sweep`` — BASELINE.json config #5: 8
   canonical-patch variants on their shared union grid, run as ONE
   ``jax.vmap``-batched program. The value is the AGGREGATE cell rate
   (cells × steps × variants / wall).

Each metric reports the best of three timed runs after a warm-up run
that compiles. The benchmark is redefined as named cells with medians,
spreads and a ``correct`` flag in a later change (ROADMAP speed item 1).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BEST_OF = 3


def _timed_run(sim):
    """Warm-up run (compile + full run), then best-of-N timed runs."""
    import jax

    out = sim.run()
    jax.block_until_ready(out["e_ratio"])
    wall = float("inf")
    for _ in range(BEST_OF):
        t0 = time.perf_counter()
        out = sim.run()
        jax.block_until_ready(out["e_ratio"])
        wall = min(wall, time.perf_counter() - t0)
    steps = int(out["steps"])

    # a NaN run can masquerade as a fast one (the energy guard returns
    # ratio=1.0 on NaN) — refuse to report garbage. The port DFTs are
    # small, and NaNs in the fields reach them by the first probe sample.
    if not np.isfinite(np.asarray(out["uf"])).all():
        raise RuntimeError("non-finite port DFTs")
    if not float(out["e_ratio"]) < 1.0:
        raise RuntimeError("energy never decayed — suspicious")
    return out, wall, steps


_DEVICE: dict = {}


def _device_detail() -> dict:
    """Platform, device kind and count from JAX, and the card's name and
    power limit from nvidia-smi (a child that stays off JAX)."""
    if not _DEVICE:
        import jax

        devs = jax.devices()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        _DEVICE.update(
            platform=devs[0].platform,
            device_kind=devs[0].device_kind,
            device_count=len(devs),
            card=smi[0].strip() if smi else "not reported",
        )
    return dict(_DEVICE)


def _emit(metric: str, sim, wall: float, steps: int,
          n_batch: int = 1) -> None:
    cells = sim.grid.num_cells
    gcells = cells * steps * n_batch / wall / 1e9
    rec = {
        "metric": metric,
        "value": round(gcells, 4),
        "unit": "Gcell-updates/s",
        "device": _device_detail(),
        "detail": {
            "grid": list(sim.grid.shape),
            "cells": cells,
            "steps": steps,
            "wall_s": round(wall, 4),
        },
    }
    if n_batch > 1:
        rec["detail"]["n_batch"] = n_batch
    print(json.dumps(rec), flush=True)


def bench_canonical_patch() -> None:
    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu.solvers.patch_fixed import prepare_patch_fixed

    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02
    )
    prep = prepare_patch_fixed(params)
    if not prep.ok:
        raise RuntimeError(prep.message)
    out, wall, steps = _timed_run(prep.sim)
    _emit("yee_cell_updates_canonical_patch", prep.sim, wall, steps)


def bench_large_mixed_scene() -> None:
    """The 4.2M-cell mixed patch+horn scene from examples/mixed_patch_horn."""
    import jax

    from fdtd_solver_antennas_tpu import HornAntennaParams, PatchAntennaParams
    from fdtd_solver_antennas_tpu.frontends.designer import MultiPatchScene

    scene = MultiPatchScene()
    scene.add_patch(
        PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02
        )
    )
    scene.add_horn(
        HornAntennaParams.from_user_units(
            frequency_ghz=2.45, throat_a_mm=86.0, throat_b_mm=43.0,
            aperture_A_mm=150.0, aperture_B_mm=110.0, length_mm=60.0,
        ),
        center_x_m=0.18, rot_z_deg=25.0,
    )
    scene.controls.mesh_quality = 2
    # prepare phase: voxelize + coefficient build + host→device uploads,
    # excluding jit compilation (which the warm-up run below pays)
    t0 = time.perf_counter()
    prep = scene.prepare()
    if not prep.ok:
        raise RuntimeError(prep.message)
    jax.block_until_ready(prep.sim.coeffs["cb_ez"])
    prep_wall = time.perf_counter() - t0
    rec = {
        "metric": "prepare_large_scene_s",
        "value": round(prep_wall, 2),
        "unit": "s",
        "device": _device_detail(),
        "detail": {
            "grid": list(prep.sim.grid.shape),
            "cells": prep.sim.grid.num_cells,
        },
    }
    print(json.dumps(rec), flush=True)
    out, wall, steps = _timed_run(prep.sim)
    _emit("yee_cell_updates_large_mixed_scene", prep.sim, wall, steps)


def bench_pml_patch() -> None:
    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu.solvers.patch_fixed import prepare_patch_fixed

    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02
    )
    prep = prepare_patch_fixed(params, boundary="PML_8")
    if not prep.ok:
        raise RuntimeError(prep.message)
    out, wall, steps = _timed_run(prep.sim)
    _emit("yee_cell_updates_pml_patch", prep.sim, wall, steps)


def bench_tall_patch_z160() -> None:
    """A patch scene on a z=160 grid (tall in z, small in x/y)."""
    import jax.numpy  # noqa: F401  (ensure jax initialized before build)
    from fdtd_solver_antennas_tpu.models.scene import Scene
    from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
    from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder

    mb = MeshBuilder()
    mb.add_line("x", list(np.linspace(-60, 60, 161)) + [-6.0])
    mb.add_line("y", np.linspace(-45, 45, 121))
    mb.add_line("z", np.linspace(-40, 56, 160))
    grid = mb.build(4.0)
    scene = Scene()
    scene.add_material_box(
        "sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0
    )
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    cfg = FDTDConfig(n_steps_max=4000, end_criteria=1e-30, check_every=500)
    sim = build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, 51),
        nf_freqs_hz=np.array([2.45e9]),
    )
    out, wall, steps = _timed_run(sim)
    _emit("yee_cell_updates_tall_patch_z160", sim, wall, steps)


def bench_geometry_sweep() -> None:
    """BASELINE.json config #5: the vmapped geometry sweep — 8
    canonical-patch design variants batched into ONE compiled program.
    The reference explores designs by serially re-preparing/re-running
    its C++ engine per candidate (gui_app.py:2772-2874)."""
    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu.solvers.sweep import (
        _run_batched,
        prepare_patch_geometry_sweep,
    )

    n_var = 8
    variants = [
        PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02,
            W_mm=37.26 + 0.5 * i, L_mm=28.83 + 0.4 * i,
        )
        for i in range(n_var)
    ]
    prep = prepare_patch_geometry_sweep(
        variants, n_steps_max=2000, end_criteria=1e-4
    )
    if not prep.ok:
        raise RuntimeError(prep.message)
    _run_batched(prep)  # warm-up: compile + full run
    wall = float("inf")
    for _ in range(BEST_OF):
        out, w, steps = _run_batched(prep)
        wall = min(wall, w)
    uf = np.asarray(out["uf"])
    if not np.isfinite(uf).all():
        raise RuntimeError("non-finite port DFTs")
    # the silent-broadcast failure mode: every variant must produce a
    # distinct spectrum (2000 steps is before the union grid's energy
    # decays, so an energy check would always read ~1.0 here — the
    # spectra are the meaningful guard)
    for i in range(1, n_var):
        if np.allclose(uf[0], uf[i], rtol=1e-3):
            raise RuntimeError(
                f"variant {i} spectrum identical to variant 0 — "
                "geometry broadcast bug")
    _emit("yee_cell_updates_geometry_sweep", prep.sim, wall, steps,
          n_batch=n_var)


def main() -> None:
    import jax

    from fdtd_solver_antennas_tpu.utils.backend import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit("bench.py measures the GPU; JAX found none")
    enable_compile_cache()
    bench_canonical_patch()
    bench_large_mixed_scene()
    bench_pml_patch()
    bench_tall_patch_z160()
    bench_geometry_sweep()


if __name__ == "__main__":
    main()
