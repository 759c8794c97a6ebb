"""Full-sphere microstrip patch solver.

Parity with ``solver_fdtd_openems_microstrip_3d.py``: same geometry as the
microstrip solver but φ = 0..360° sampling with configurable θ/φ steps and
the mesh-quality → points-per-wavelength map {1:12, 2:16, 3:20, 4:25, 5:32}
(reference: microstrip_3d.py:103).

The reference's runner loops per-φ because the openEMS NF2FF helper takes
one cut at a time (microstrip_3d.py:221-248); our transform is a single
einsum over the whole (θ, φ) grid — no loop, one matmul-heavy program.
"""

from __future__ import annotations

import time

import numpy as np

import jax

from ..models.params import PatchAntennaParams
from ..ops.fdtd import FDTDConfig, build_simulation
from ..physics import C0
from ..post.nf2ff import nf2ff_transform, select_face_freqs
from ..post.ports import find_resonance, port_spectra
from .base import FDTDSolverResult, SolverPrepared, radiation_efficiency
from .microstrip import FeedDirection, build_microstrip_scene

PPW_MAP = {1: 12.0, 2: 16.0, 3: 20.0, 4: 25.0, 5: 32.0}


def prepare_microstrip_patch_3d(
    params: PatchAntennaParams,
    *,
    dll_dir: str = "",  # parity arg, ignored
    feed_direction: FeedDirection = FeedDirection.NEG_X,
    feed_line_length_mm: float = 20.0,
    boundary: str = "MUR",
    theta_step_deg: float = 2.0,
    phi_step_deg: float = 5.0,
    mesh_quality: int = 3,
    work_dir: str = "",  # parity arg, ignored
    cleanup: bool = True,  # parity arg, ignored
    verbose: int = 0,
    n_steps_max: int = 30_000,
    end_criteria: float = 1e-4,
) -> SolverPrepared:
    try:
        f0 = params.frequency_hz
        fc = f0 / 2.0
        try:
            q = int(mesh_quality)
        except Exception:
            q = 3
        q = max(1, min(5, q))
        ppw = PPW_MAP.get(q, 20.0)
        mesh_res = C0 / (f0 + fc) / 1e-3 / ppw

        feed_direction = FeedDirection(feed_direction)
        scene, mb, info = build_microstrip_scene(
            params, feed_direction, feed_line_length_mm, mesh_res
        )
        grid = mb.build(mesh_res, ratio=1.4)
        cfg = FDTDConfig(
            n_steps_max=n_steps_max, end_criteria=end_criteria, boundary=boundary
        )
        sim = build_simulation(
            scene, grid, f0=f0, fc=fc, cfg=cfg,
            # deviation from the reference's max(1e9, 0.7 f0) floor
            # (solver_fdtd_openems_microstrip.py:408): for sub-GHz
            # antennas that floor yields a DESCENDING sweep that
            # excludes the design frequency — clamp so the sweep is
            # always ascending and contains f0
            port_freqs_hz=np.linspace(
                min(max(1e8, 0.7 * f0), 0.9 * f0), f0 * 1.3, 201),
        )

        t_step = max(0.5, float(theta_step_deg))
        p_step = max(1.0, float(phi_step_deg))
        theta = np.arange(0.0, 181.0, t_step)
        phi = np.arange(0.0, 360.0 + p_step, p_step)
        nf_center = np.array([0.0, 0.0, info["h"] / 2000.0])

        if verbose:
            print(
                f"microstrip 3D prepared: grid {grid.shape} "
                f"({grid.num_cells} cells, ppw {ppw})"
            )
        return SolverPrepared(
            True,
            f"Microstrip 3D prepared (feed {feed_direction.value}, "
            f"quality {q} → {ppw:g} ppw, grid {grid.shape})",
            sim=sim,
            theta=theta,
            phi=phi,
            nf_center=nf_center,
            diagnostics=info,
        )
    except Exception as e:
        return SolverPrepared(False, f"Microstrip 3D prepare failed: {e}")


def run_prepared_microstrip_3d(
    prepared: SolverPrepared,
    *,
    frequency_hz: float,
    verbose: int = 1,
) -> FDTDSolverResult:
    """Full-sphere pattern (reference runner: microstrip_3d.py:199-256)."""
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        sim = prepared.sim

        t_start = time.perf_counter()
        out = sim.run()
        jax.block_until_ready(out["uf"])
        steps = int(out["steps"])
        wall = time.perf_counter() - t_start

        spectra = port_spectra(
            sim.port_freqs_hz, np.asarray(out["uf"][0]), np.asarray(out["if_"][0]),
            sim.dft_dt, z_ref=50.0,
        )
        f_res, s11_db_res = find_resonance(spectra, frequency_hz)

        fi = int(np.argmin(np.abs(sim.nf_freqs_hz - f_res)))
        theta = np.asarray(prepared.theta)
        phi = np.asarray(prepared.phi)
        ff = nf2ff_transform(
            sim.faces,
            select_face_freqs(out["nf_e"], fi),
            select_face_freqs(out["nf_h"], fi),
            sim.dft_dt,
            sim.nf_freqs_hz[fi : fi + 1],
            theta,
            phi,
            center_m=prepared.nf_center,
        )
        rad_eff, rad_eff_conv = radiation_efficiency(
            ff, spectra, float(out["e_ratio"])
        )
        return FDTDSolverResult(
            True,
            "Microstrip 3D pattern computed",
            theta=np.deg2rad(theta),
            phi=np.deg2rad(phi),
            intensity=ff.intensity_dbi(0),
            is_dBi=True,
            freq=spectra.freq_hz,
            s11=spectra.s11,
            z_in=spectra.z_in,
            f_res_hz=f_res,
            Dmax=float(ff.Dmax[0]),
            radiated_power_w=float(ff.P_rad[0]),
            radiation_efficiency=rad_eff,
            steps_run=steps,
            wall_time_s=wall,
            mcells_per_s=sim.grid.num_cells * steps / wall / 1e6,
            diagnostics={
                "s11_db_at_res": s11_db_res,
                "nf2ff_freq_hz": float(sim.nf_freqs_hz[fi]),
                "energy_ratio": float(out["e_ratio"]),
                "rad_eff_converged": rad_eff_conv,
            },
        )
    except Exception as e:
        return FDTDSolverResult(False, f"Microstrip 3D run failed: {e}")


# Reference-parity aliases
prepare_openems_microstrip_patch_3d = prepare_microstrip_patch_3d
run_prepared_openems_microstrip_3d = run_prepared_microstrip_3d
