"""Microstrip-fed patch antenna solver.

Reproduces the reference's realistic PCB-style patch with a 50 Ω microstrip
feed (``solver_fdtd_openems_microstrip.py:134-477``): Wheeler width
synthesis, 4 feed directions, substrate sized patch + 30 mm margin + feed
length, lumped port bridging patch↔ground at the feed edge (the reference
replaced its MSL port with this, microstrip.py:307-324), S11 post-processing
with the uf_ref/uf_inc contract, and NF2FF at the discovered resonance on
θ = 0..180° / φ = {0°, 90°}.
"""

from __future__ import annotations

import math
import time
from enum import Enum
from typing import Tuple

import numpy as np

import jax

from ..models.params import PatchAntennaParams
from ..models.scene import MSLPortSpec, Scene
from ..ops.fdtd import FDTDConfig, build_simulation
from ..ops.mesh import MeshBuilder
from ..physics import C0, design_patch_for_frequency, substrate_conductivity
from ..post.nf2ff import nf2ff_transform, select_face_freqs
from ..post.ports import find_resonance, msl_port_spectra, port_spectra
from .base import FDTDSolverResult, SolverPrepared, SolverProbe, radiation_efficiency
from .patch_fixed import probe_fdtd


class FeedDirection(str, Enum):
    """Microstrip feed direction (reference: microstrip.py:29-34)."""

    POS_X = "+X"
    NEG_X = "-X"
    POS_Y = "+Y"
    NEG_Y = "-Y"


def calculate_microstrip_width(
    freq_hz: float, eps_r: float, h_m: float, z0: float = 50.0
) -> float:
    """Microstrip width for a target Z0 via Wheeler's synthesis equations
    (reference contract: microstrip.py:84-112)."""
    if z0 < 44.0:
        A = (z0 / 60.0) * math.sqrt((eps_r + 1.0) / 2.0) + (
            (eps_r - 1.0) / (eps_r + 1.0)
        ) * (0.23 + 0.11 / eps_r)
        w_h = 8.0 * math.exp(A) / (math.exp(2.0 * A) - 2.0)
    else:
        B = 377.0 * math.pi / (2.0 * z0 * math.sqrt(eps_r))
        w_h = (2.0 / math.pi) * (
            B
            - 1.0
            - math.log(2.0 * B - 1.0)
            + ((eps_r - 1.0) / (2.0 * eps_r))
            * (math.log(B - 1.0) + 0.39 - 0.61 / eps_r)
        )
    return w_h * h_m


def probe_openems_microstrip(dll_dir: str = "") -> SolverProbe:
    """Parity probe (reference: microstrip.py:115-131); checks JAX."""
    return probe_fdtd(dll_dir)


def build_microstrip_scene(
    params: PatchAntennaParams,
    feed_direction: FeedDirection,
    feed_line_length_mm: float,
    mesh_res_mm: float,
    port_mode: str = "lumped",
) -> Tuple[Scene, MeshBuilder, dict]:
    """Shared geometry builder for the microstrip solvers.

    Returns (scene, mesh builder, info) where info holds patch/substrate
    dimensions in mm. Geometry contract: reference microstrip.py:176-332.
    """
    f0 = params.frequency_hz
    if params.patch_length_m and params.patch_width_m:
        patch_L = params.patch_length_m * 1e3
        patch_W = params.patch_width_m * 1e3
    else:
        L_m, W_m, _ = design_patch_for_frequency(f0, params.eps_r, params.h_m)
        patch_L = L_m * 1e3
        patch_W = W_m * 1e3
    h = params.h_m * 1e3
    feed_width = calculate_microstrip_width(f0, params.eps_r, params.h_m) * 1e3
    margin = 30.0
    fl = float(feed_line_length_mm)

    if feed_direction in (FeedDirection.POS_X, FeedDirection.NEG_X):
        sub_W = patch_W + 2 * margin + fl
        sub_L = patch_L + 2 * margin
    else:
        sub_W = patch_W + 2 * margin
        sub_L = patch_L + 2 * margin + fl

    air = 50.0
    box_x = sub_W + 2 * air
    box_y = sub_L + 2 * air
    box_z = 160.0

    kappa = substrate_conductivity(f0, params.eps_r, params.loss_tangent)
    scene = Scene()
    scene.add_material_box(
        "substrate", params.eps_r, kappa,
        [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, h], priority=0,
    )
    scene.add_metal_box(
        "ground", [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, 0.0],
        priority=10,
    )
    scene.add_metal_box(
        "patch", [-patch_W / 2, -patch_L / 2, h], [patch_W / 2, patch_L / 2, h],
        priority=10,
    )

    # feed strip geometry + port feed point at the patch edge center
    if feed_direction == FeedDirection.NEG_X:
        feed_lo = [-sub_W / 2, -feed_width / 2, h]
        feed_hi = [-patch_W / 2, feed_width / 2, h]
        feed_px, feed_py = -patch_W / 2, 0.0
    elif feed_direction == FeedDirection.POS_X:
        feed_lo = [patch_W / 2, -feed_width / 2, h]
        feed_hi = [sub_W / 2, feed_width / 2, h]
        feed_px, feed_py = patch_W / 2, 0.0
    elif feed_direction == FeedDirection.NEG_Y:
        feed_lo = [-feed_width / 2, -sub_L / 2, h]
        feed_hi = [feed_width / 2, -patch_L / 2, h]
        feed_px, feed_py = 0.0, -patch_L / 2
    else:
        feed_lo = [-feed_width / 2, patch_L / 2, h]
        feed_hi = [feed_width / 2, sub_L / 2, h]
        feed_px, feed_py = 0.0, patch_L / 2
    scene.add_metal_box("feed_line", feed_lo, feed_hi, priority=10)

    msl_positions = None
    if port_mode == "msl":
        # distributed microstrip-line port on the feed strip: excitation
        # near the substrate edge, measurement plane further inboard.
        # (The reference's MSL path exists but is force-disabled,
        # multi_3d.py:458-467; here it works.)
        if feed_direction in (FeedDirection.NEG_X, FeedDirection.POS_X):
            prop = "x"
            strip_center = 0.0
            edge = -sub_W / 2 if feed_direction == FeedDirection.NEG_X else sub_W / 2
            inward = 1.0 if feed_direction == FeedDirection.NEG_X else -1.0
        else:
            prop = "y"
            strip_center = 0.0
            edge = -sub_L / 2 if feed_direction == FeedDirection.NEG_Y else sub_L / 2
            inward = 1.0 if feed_direction == FeedDirection.NEG_Y else -1.0
        exc = edge + inward * 3.0
        meas = edge + inward * min(10.0, fl / 2)
        # the 3-probe deembedding needs the measurement stencil clear of
        # the soft-source discontinuity: with a short feed line the meas
        # plane lands on (or behind) the excitation plane and the probed
        # dEt/dHt straddle the source — garbage Z_L/β with no error
        if inward * (meas - exc) < 3.0:
            raise ValueError(
                f"feed_line_length_mm={fl:g} is too short for the MSL "
                "3-probe deembedding (measurement plane must sit ≥3 mm "
                "beyond the excitation plane); lengthen the feed line "
                "or use port_mode='lumped'"
            )
        scene.add_msl_port(MSLPortSpec(
            port_id=1, prop_axis=prop, strip_center_mm=strip_center,
            strip_width_mm=feed_width, height_mm=h,
            exc_pos_mm=exc, meas_pos_mm=meas, z0_ohm=50.0, excite=1.0,
        ))
        msl_positions = (prop, exc, meas)
    else:
        scene.add_lumped_port(
            1, 50.0, [feed_px, feed_py, 0.0], [feed_px, feed_py, h],
            direction="z", excite=1.0,
        )

    mb = MeshBuilder()
    mb.add_line("x", [-box_x / 2, box_x / 2])
    mb.add_line("y", [-box_y / 2, box_y / 2])
    mb.add_line("z", [-box_z / 3, box_z * 2 / 3])
    mb.add_line("z", np.linspace(0.0, h, 5))
    mb.add_metal_edges(
        [-sub_W / 2, -sub_L / 2, 0.0], [sub_W / 2, sub_L / 2, 0.0], dirs="xy"
    )
    mb.add_metal_edges(
        [-patch_W / 2, -patch_L / 2, h], [patch_W / 2, patch_L / 2, h],
        dirs="xy", metal_edge_res=mesh_res_mm / 2,
    )
    mb.add_metal_edges(feed_lo, feed_hi, dirs="xy", metal_edge_res=mesh_res_mm / 2)
    mb.add_line("x", [float(feed_px)])
    mb.add_line("y", [float(feed_py)])
    if msl_positions is not None:
        prop, exc, meas = msl_positions
        mb.add_line(prop, [float(exc), float(meas)])
    if feed_direction in (FeedDirection.NEG_X, FeedDirection.POS_X):
        mb.add_line("y", [-feed_width / 2, 0.0, feed_width / 2])
    else:
        mb.add_line("x", [-feed_width / 2, 0.0, feed_width / 2])

    info = dict(
        patch_L=patch_L, patch_W=patch_W, h=h, sub_W=sub_W, sub_L=sub_L,
        feed_width=feed_width,
    )
    return scene, mb, info


def prepare_microstrip_patch(
    params: PatchAntennaParams,
    *,
    dll_dir: str = "",  # parity arg, ignored
    feed_direction: FeedDirection = FeedDirection.NEG_X,
    feed_line_length_mm: float = 20.0,
    boundary: str = "MUR",
    theta_step_deg: float = 2.0,
    port_mode: str = "lumped",  # 'lumped' (reference contract) | 'msl'
    work_dir: str = "",  # parity arg, ignored
    cleanup: bool = True,  # parity arg, ignored
    verbose: int = 0,
    n_steps_max: int = 30_000,
    end_criteria: float = 1e-4,
) -> SolverPrepared:
    try:
        f0 = params.frequency_hz
        fc = f0 / 2.0
        mesh_res = C0 / (f0 + fc) / 1e-3 / 20.0
        feed_direction = FeedDirection(feed_direction)
        scene, mb, info = build_microstrip_scene(
            params, feed_direction, feed_line_length_mm, mesh_res,
            port_mode=port_mode,
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

        step = max(0.5, float(theta_step_deg))
        theta = np.arange(0.0, 181.0, step)
        phi = np.array([0.0, 90.0])
        nf_center = np.array([0.0, 0.0, info["h"] / 2000.0])  # substrate mid, m

        if verbose:
            print(
                f"microstrip prepared: grid {grid.shape}, feed {feed_direction}, "
                f"w={info['feed_width']:.2f} mm"
            )
        return SolverPrepared(
            True,
            f"Microstrip patch prepared (feed: {feed_direction.value}, grid "
            f"{grid.shape})",
            sim=sim,
            theta=theta,
            phi=phi,
            nf_center=nf_center,
            diagnostics=info,
        )
    except Exception as e:
        return SolverPrepared(False, f"Microstrip solver prepare failed: {e}")


def run_prepared_microstrip(
    prepared: SolverPrepared,
    *,
    frequency_hz: float,
    verbose: int = 1,
) -> FDTDSolverResult:
    """Run + port calc + NF2FF (reference: microstrip.py:369-477)."""
    try:
        if not prepared.ok or prepared.sim is None:
            return FDTDSolverResult(False, prepared.message)
        sim = prepared.sim

        t_start = time.perf_counter()
        out = sim.run()
        jax.block_until_ready(out["uf"])
        steps = int(out["steps"])
        wall = time.perf_counter() - t_start
        mcells = sim.grid.num_cells * steps / wall / 1e6

        if sim.msl_ports:
            # MSL port: 3-probe deembedding over the port's probe rows
            # (rows come after any lumped ports; see port_probe_sources)
            msl = sim.msl_ports[0]
            base = len(sim.ports)
            spectra = msl_port_spectra(
                sim.port_freqs_hz,
                np.asarray(out["uf"][base : base + 3]),
                np.asarray(out["if_"][base : base + 2]),
                sim.dft_dt,
                msl.v_pos_m,
                msl.i_pos_m,
                z0_nominal=msl.z_ref,
            )
        else:
            spectra = port_spectra(
                sim.port_freqs_hz, np.asarray(out["uf"][0]),
                np.asarray(out["if_"][0]), sim.dft_dt, z_ref=50.0,
            )
        f_res, s11_db_res = find_resonance(spectra, frequency_hz)
        if verbose:
            if s11_db_res is not None:
                print(
                    f"Found resonance at {f_res / 1e9:.3f} GHz "
                    f"(S11 = {s11_db_res:.1f} dB)"
                )
            else:
                print(
                    f"No clear resonance found, using target "
                    f"{f_res / 1e9:.3f} GHz"
                )

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
            "Microstrip simulation completed successfully",
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
            mcells_per_s=mcells,
            diagnostics={
                "s11_db_at_res": s11_db_res,
                "nf2ff_freq_hz": float(sim.nf_freqs_hz[fi]),
                "energy_ratio": float(out["e_ratio"]),
                "rad_eff_converged": rad_eff_conv,
                "port_spectra": spectra,
            },
        )
    except Exception as e:
        return FDTDSolverResult(False, f"Microstrip simulation failed: {e}")


# Reference-parity aliases
prepare_openems_microstrip_patch = prepare_microstrip_patch
run_prepared_openems_microstrip = run_prepared_microstrip
