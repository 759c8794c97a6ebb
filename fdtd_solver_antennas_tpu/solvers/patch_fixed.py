"""Canonical 3D patch solver ("fixed" solver parity).

Re-creates the reference's tutorial-faithful scene and run budget
(``solver_fdtd_openems_fixed.py:113-342``) on the in-repo FDTD engine:

- air box 200×200×150 mm with the z-split at −⅓/+⅔ (fixed.py:184-186)
- 60×60 mm substrate, 4 cells across its thickness (fixed.py:151-202)
- PEC patch (designed or user L/W) and same-size ground plane
- coax-style lumped port at x = −6 mm, R = 50 Ω, z-directed (fixed.py:215)
- Gaussian excitation f0, fc = f0/2; MUR walls; NrTS 30000, EndCriteria 1e-4
- mesh λ/20 with metal-edge refinement λ/40 (fixed.py:180,193)
- NF2FF θ = 0..178° step 2°, φ = {0°, 90°}, center (0,0,1 mm)

Differences by design: substrate conductivity uses the correct
κ = 2πf·ε0·εr·tanδ (the reference's fixed solver has a spurious 1e-3,
fixed.py:153 — documented defect), and post-processing is in-memory with an
S11 sweep always available (the reference's fixed path has no port calc).
"""

from __future__ import annotations

import time

import numpy as np

import jax

from ..models.params import PatchAntennaParams
from ..models.scene import Scene
from ..ops.fdtd import FDTDConfig, build_simulation
from ..ops.mesh import MeshBuilder
from ..physics import C0, design_patch_for_frequency, substrate_conductivity
from ..post.nf2ff import nf2ff_transform, select_face_freqs
from ..post.ports import find_resonance, port_spectra
from .base import FDTDSolverResult, SolverPrepared, SolverProbe, radiation_efficiency


def probe_fdtd(dll_dir: str = "") -> SolverProbe:
    """Capability check: is a JAX backend alive?

    API-parity stand-in for the reference's DLL discovery
    (``probe_openems_fixed``, fixed.py:92-110) — there are no DLLs to find;
    we report the JAX backend, device kind and devices instead.
    ``dll_dir`` is accepted and ignored so call sites keep working.
    """
    try:
        devices = jax.devices()
        api = {
            "backend": [devices[0].platform],
            "device_kind": [devices[0].device_kind],
            "devices": [str(d) for d in devices],
        }
        return SolverProbe(True, f"JAX backend ready: {devices}", api)
    except Exception as e:  # pragma: no cover
        return SolverProbe(False, f"JAX backend unavailable: {e}", {})


def prepare_patch_fixed(
    params: PatchAntennaParams,
    *,
    dll_dir: str = "",  # parity arg, ignored
    work_dir: str = "",  # parity arg, ignored (runs are in-memory)
    cleanup: bool = True,  # parity arg, ignored
    verbose: int = 0,
    n_steps_max: int = 30_000,
    end_criteria: float = 1e-4,
    boundary: str = "MUR",
    lossy_metal: bool = False,
) -> SolverPrepared:
    """Build the canonical patch scene and compile the simulation.

    ``lossy_metal=True`` models the patch and ground as finite-conductivity
    sheets of ``params.metal`` (skin-depth-capped sheet conductance at f0)
    instead of PEC, so conductor loss enters the power balance physically —
    beyond the reference, whose openEMS metal is always PEC.
    """
    try:
        f0 = params.frequency_hz
        fc = f0 / 2.0

        if params.patch_length_m and params.patch_width_m:
            patch_W = params.patch_width_m * 1e3  # x (resonant) dimension, mm
            patch_L = params.patch_length_m * 1e3  # y dimension, mm
        else:
            L_m, W_m, _ = design_patch_for_frequency(f0, params.eps_r, params.h_m)
            patch_W = W_m * 1e3
            patch_L = L_m * 1e3

        h = params.h_m * 1e3
        sub_W = 60.0
        sub_L = 60.0
        substrate_cells = 4
        feed_pos = -6.0
        feed_R = 50.0
        sim_box = np.array([200.0, 200.0, 150.0])
        kappa = substrate_conductivity(f0, params.eps_r, params.loss_tangent)

        scene = Scene()
        scene.add_material_box(
            "substrate", params.eps_r, kappa,
            [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, h], priority=0,
        )
        if lossy_metal:
            from ..physics import sheet_conductance

            sig_s = sheet_conductance(
                params.metal.conductivity_s_per_m, params.metal.thickness_m, f0
            )
            add_metal = lambda name, lo, hi: scene.add_conductive_sheet(
                name, sig_s, lo, hi, priority=10
            )
        else:
            add_metal = lambda name, lo, hi: scene.add_metal_box(
                name, lo, hi, priority=10
            )
        add_metal(
            "patch",
            [-patch_W / 2, -patch_L / 2, h], [patch_W / 2, patch_L / 2, h],
        )
        add_metal(
            "gnd",
            [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, 0.0],
        )
        scene.add_lumped_port(
            1, feed_R, [feed_pos, 0.0, 0.0], [feed_pos, 0.0, h],
            direction="z", excite=1.0,
        )

        mesh_res = C0 / (f0 + fc) / 1e-3 / 20.0  # λ/20 in mm (fixed.py:180)
        mb = MeshBuilder()
        mb.add_line("x", [-sim_box[0] / 2, sim_box[0] / 2])
        mb.add_line("y", [-sim_box[1] / 2, sim_box[1] / 2])
        mb.add_line("z", [-sim_box[2] / 3, sim_box[2] * 2 / 3])
        mb.add_metal_edges(
            [-patch_W / 2, -patch_L / 2, h], [patch_W / 2, patch_L / 2, h],
            dirs="xy", metal_edge_res=mesh_res / 2,
        )
        mb.add_metal_edges(
            [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, 0.0], dirs="xy"
        )
        mb.add_line("z", np.linspace(0.0, h, substrate_cells + 1))
        mb.add_line("x", [feed_pos])
        mb.add_line("y", [0.0])
        grid = mb.build(mesh_res, ratio=1.4)

        cfg = FDTDConfig(
            n_steps_max=n_steps_max,
            end_criteria=end_criteria,
            boundary=boundary,
        )
        sim = build_simulation(scene, grid, f0=f0, fc=fc, cfg=cfg)

        theta = np.arange(0.0, 180.0, 2.0)  # degrees (fixed.py:230)
        phi = np.array([0.0, 90.0])
        nf_center = np.array([0.0, 0.0, 1e-3])  # meters (fixed.py:234)

        if verbose:
            print(f"grid {grid.shape} = {grid.num_cells} cells, dt={sim.dt:.3e}s")

        return SolverPrepared(
            True,
            f"Fixed solver prepared (grid {grid.shape}, "
            f"{grid.num_cells} cells)",
            sim=sim,
            theta=theta,
            phi=phi,
            nf_center=nf_center,
        )
    except Exception as e:
        return SolverPrepared(False, f"Fixed solver prepare failed: {e}")


def run_prepared_fixed(
    prepared: SolverPrepared,
    *,
    frequency_hz: float,
    verbose: int = 1,
    progress_cb=None,
    abort_cb=None,
) -> FDTDSolverResult:
    """Run the compiled simulation and extract the dBi pattern grid.

    Mirrors ``run_prepared_openems_fixed`` (fixed.py:257-342): NF2FF at the
    requested frequency, dBi via 20·log10(E/Emax) + 10·log10(Dmax) — plus
    the S11 sweep the engine gets for free from the port DFTs.
    ``progress_cb``/``abort_cb`` follow :meth:`PreparedSimulation.run`.
    """
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        sim = prepared.sim

        t_start = time.perf_counter()
        out = sim.run(progress_cb=progress_cb, abort_cb=abort_cb)
        steps = int(out["steps"])
        jax.block_until_ready(out["uf"])
        wall = time.perf_counter() - t_start
        if out.get("aborted"):
            return FDTDSolverResult(
                False,
                f"Run aborted by user at step {steps}/"
                f"{sim.cfg.n_steps_max} ({wall:.1f}s elapsed)",
                diagnostics={"aborted": True, "steps_done": steps},
            )
        mcells = sim.grid.num_cells * steps / wall / 1e6

        if verbose:
            print(
                f"FDTD done: {steps} steps, {wall:.2f}s, {mcells:.1f} Mcells/s, "
                f"energy ratio {float(out['e_ratio']):.2e}"
            )

        spectra = port_spectra(
            sim.port_freqs_hz, np.asarray(out["uf"][0]), np.asarray(out["if_"][0]),
            sim.dft_dt, z_ref=sim.ports[0].spec.resistance,
        )
        f_res, s11_db = find_resonance(spectra, frequency_hz)

        # NF2FF at the accumulated frequency nearest the resonance
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
        intensity_db = ff.intensity_dbi(0)

        rad_eff, rad_eff_conv = radiation_efficiency(
            ff, spectra, float(out["e_ratio"])
        )
        return FDTDSolverResult(
            True,
            "FDTD completed",
            theta=np.deg2rad(theta),
            phi=np.deg2rad(phi),
            intensity=intensity_db,
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
            mcells_per_s=mcells,
            diagnostics={
                "s11_db_at_res": s11_db,
                "nf2ff_freq_hz": float(sim.nf_freqs_hz[fi]),
                "energy_ratio": float(out["e_ratio"]),
                "rad_eff_converged": rad_eff_conv,
            },
        )
    except Exception as e:
        return FDTDSolverResult(False, f"Fixed run failed: {e}")


# Reference-parity aliases (antenna_sim/__init__.py names)
probe_openems_fixed = probe_fdtd
prepare_openems_patch_fixed = prepare_patch_fixed
run_prepared_openems_fixed = run_prepared_fixed
