"""Batched geometry sweeps: many designs, one compiled program.

The reference explores designs by serially re-``prepare``/re-``Run``-ing
the C++ engine per variant (GUI reruns; BASELINE.json config #5 names the
"vmapped geometry sweep" as this framework's replacement). Here every
variant is voxelized onto one *shared canonical grid* (the union of all
variants' mesh-refinement lines, per SURVEY §7's ragged-grid resolution:
geometry differences live purely in coefficient arrays), the coefficient
pytrees are stacked on a batch axis, and the full chunked time loop runs
under ``jax.vmap`` — an S11 sweep over N designs is a single XLA program
instead of N engine launches.

Early-exit note: under vmap the while_loop runs until *all* variants meet
the energy criterion; already-converged variants keep stepping, which only
adds negligible (decayed-field) DFT contributions.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..models.params import PatchAntennaParams
from ..models.scene import Scene
from ..ops.fdtd import FDTDConfig, _make_run_fn, build_simulation
from ..ops.mesh import MeshBuilder
from ..physics import C0, design_patch_for_frequency, substrate_conductivity
from ..post.ports import PortSpectra, find_resonance, port_spectra


@dataclasses.dataclass
class SweepPrepared:
    ok: bool
    message: str
    sim: object = None  # base PreparedSimulation (variant 0)
    batched_coeffs: Optional[Dict[str, jnp.ndarray]] = None
    variants: Optional[List] = None  # PatchAntennaParams | HornAntennaParams
    # far-field post-processing inputs (horn sweeps)
    theta: Optional[np.ndarray] = None  # degrees
    phi: Optional[np.ndarray] = None  # degrees
    nf_centers: Optional[List[np.ndarray]] = None  # per-variant, meters
    _vrun: object = None
    # sweep-level device sharding (parallel/sweep_shard.py): rows past
    # len(variants) are padding and are ignored by the result loops
    _sweep_pad: int = 0
    _sweep_mesh: object = None


@dataclasses.dataclass
class SweepResult:
    ok: bool
    message: str
    spectra: Optional[List[PortSpectra]] = None
    f_res_hz: Optional[np.ndarray] = None
    s11_min_db: Optional[np.ndarray] = None
    Dmax_dbi: Optional[np.ndarray] = None  # horn sweeps: per-variant gain
    steps_run: int = 0
    wall_time_s: float = 0.0
    mcells_per_s: float = 0.0


def _make_vmapped_run(base) -> object:
    """Jit the vmapped chunked run for a sweep.

    The coefficient arrays are runtime operands of the traced run (the
    device while_loop — a host loop cannot be vmapped), so ``jax.vmap``
    batches every variant's own geometry through one compiled step.
    """
    run_raw = _make_run_fn(base, *base._aux)
    jitted = jax.jit(jax.vmap(run_raw, in_axes=(0, None, None, None, None)))
    # sweep variants share the base sim's (fixed) excitation: bind the
    # source operands once, broadcast across the batch (in_axes=None)
    src_ops = run_raw.build_src_ops()

    def vrun(coeffs, waveform, w_port, w_nf):
        return jitted(coeffs, waveform, w_port, w_nf, src_ops)

    return vrun


def _patch_dims_mm(p: PatchAntennaParams):
    if p.patch_length_m and p.patch_width_m:
        return p.patch_width_m * 1e3, p.patch_length_m * 1e3
    L_m, W_m, _ = design_patch_for_frequency(p.frequency_hz, p.eps_r, p.h_m)
    return W_m * 1e3, L_m * 1e3


def _variant_scene(p: PatchAntennaParams, feed_pos: float) -> Scene:
    """Canonical fixed-solver scene for one variant (60×60 substrate)."""
    W, L = _patch_dims_mm(p)
    h = p.h_m * 1e3
    kappa = substrate_conductivity(p.frequency_hz, p.eps_r, p.loss_tangent)
    scene = Scene()
    scene.add_material_box(
        "substrate", p.eps_r, kappa, [-30, -30, 0.0], [30, 30, h], priority=0
    )
    scene.add_metal_box("patch", [-W / 2, -L / 2, h], [W / 2, L / 2, h], 10)
    scene.add_metal_box("gnd", [-30, -30, 0.0], [30, 30, 0.0], 10)
    scene.add_lumped_port(
        1, 50.0, [feed_pos, 0.0, 0.0], [feed_pos, 0.0, h], direction="z"
    )
    return scene


def _patch_axis_masks(comp: str, grid, padded_shape,
                      W: float, L: float, h: float):
    """Per-axis boolean vectors (padded lengths) whose outer AND equals
    the voxelizer's ``_inflated_contains`` over ``_edge_midpoints`` for
    the axis-aligned patch sheet [-W/2,-L/2,h]-[W/2,L/2,h] (containment
    of an untransformed box is separable; same inflation: degenerate
    axes +/- the sheet tolerance, finite axes +/- 1e-9). Pad slots are
    False."""
    from ..models.scene import Box, PEC
    from ..ops.voxelize import _edge_axes, _inflated_bounds

    box = Box(PEC("patch"), (-W / 2, -L / 2, h), (W / 2, L / 2, h))
    lo, hi = _inflated_bounds(box)
    out = []
    for a, v in enumerate(_edge_axes(grid, comp)):
        m = np.zeros(padded_shape[a], bool)
        v = np.asarray(v, float)
        m[: len(v)] = (v >= lo[a]) & (v <= hi[a])
        out.append(m)
    return out


def _shared_substrate(variants: Sequence[PatchAntennaParams]) -> bool:
    v0 = variants[0]
    return all(
        v.eps_r == v0.eps_r
        and v.loss_tangent == v0.loss_tangent
        and v.frequency_hz == v0.frequency_hz
        for v in variants
    )


def _batched_coeffs_delta(variants, grid, feed_pos_mm, f0, fc, cfg,
                          port_freqs, nf_freqs):
    """Sweep coefficients without N full voxelize+build passes.

    Patch-sweep variants share everything except the patch metal sheet
    (substrate, ground, port are identical), so: build ONE *naked* sim
    (scene minus the patch box -- PEC paint is the voxelizer's last
    step, so removing it leaves exactly the pre-PEC ca/cb), then stamp
    each variant's patch as a separable per-axis mask zero, applied ON
    DEVICE: upload the 6 naked arrays once (~34 MB) plus (B, axis)
    boolean masks (KBs), and a jitted ``where`` broadcasts the batch --
    the (B, X, Y, Z) batched coefficients never exist on the host.
    Bitwise-equal to per-variant ``build_simulation`` coeffs (pinned by
    tests/test_sweep.py::test_delta_coeffs_match_full_build).

    Returns ``(base_sim, batched)``; the naked base sim carries the
    shared port/waveform/faces machinery for ``_make_vmapped_run``.
    """
    naked = _variant_scene(variants[0], feed_pos_mm)
    naked.boxes = [b for b in naked.boxes if b.prop.name != "patch"]
    sim = build_simulation(
        naked, grid, f0=f0, fc=fc, cfg=cfg,
        port_freqs_hz=port_freqs, nf_freqs_hz=nf_freqs,
    )
    base = sim._coeffs_np  # host copies; no device readback
    pshape = sim.padded_shape or grid.shape
    h = variants[0].h_m * 1e3

    @jax.jit
    def _stamp(arr, mx, my, mz):
        m = mx[:, :, None, None] & my[:, None, :, None] & mz[:, None, None, :]
        return jnp.where(m, jnp.float32(0.0), arr[None])

    batched = {}
    for comp in ("ex", "ey", "ez"):
        per_axis = [
            _patch_axis_masks(comp, grid, pshape, *_patch_dims_mm(v), h)
            for v in variants
        ]
        masks = [
            jnp.asarray(np.stack([pa[a] for pa in per_axis]))
            for a in range(3)
        ]
        for pre in ("ca_", "cb_"):
            batched[pre + comp] = _stamp(
                jnp.asarray(base[pre + comp]), *masks
            )
    for k in base:  # any non-ca/cb coefficient keys are variant-independent
        if k not in batched:
            batched[k] = jnp.broadcast_to(
                jnp.asarray(base[k])[None], (len(variants),) + base[k].shape
            )
    return sim, batched


def prepare_patch_geometry_sweep(
    variants: Sequence[PatchAntennaParams],
    *,
    feed_pos_mm: float = -6.0,
    n_steps_max: int = 16_000,
    end_criteria: float = 1e-4,
    boundary: str = "MUR",
    verbose: int = 0,
) -> SweepPrepared:
    """Build the shared grid + stacked coefficients for a design sweep.

    All variants must share substrate thickness (the grid's z lines).
    """
    try:
        variants = list(variants)
        if not variants:
            return SweepPrepared(False, "No variants provided.")
        h0 = variants[0].h_m
        if any(abs(v.h_m - h0) > 1e-12 for v in variants):
            return SweepPrepared(
                False, "All sweep variants must share substrate thickness h."
            )
        f0 = max(v.frequency_hz for v in variants)
        fc = f0 / 2.0
        h = h0 * 1e3
        mesh_res = C0 / (f0 + fc) / 1e-3 / 20.0

        # union mesh: every variant's metal edges refine the shared grid
        mb = MeshBuilder()
        mb.add_line("x", [-100.0, 100.0])
        mb.add_line("y", [-100.0, 100.0])
        mb.add_line("z", [-50.0, 100.0])
        mb.add_line("z", np.linspace(0.0, h, 5))
        mb.add_line("x", [feed_pos_mm])
        mb.add_line("y", [0.0])
        mb.add_metal_edges([-30, -30, 0], [30, 30, 0], dirs="xy")
        for v in variants:
            W, L = _patch_dims_mm(v)
            mb.add_metal_edges(
                [-W / 2, -L / 2, h], [W / 2, L / 2, h], dirs="xy",
                metal_edge_res=mesh_res / 2,
            )
        grid = mb.build(mesh_res, ratio=1.4)

        cfg = FDTDConfig(
            n_steps_max=n_steps_max, end_criteria=end_criteria,
            boundary=boundary,
        )
        port_freqs = np.linspace(max(1e8, f0 * 0.5), f0 * 1.5, 201)
        nf_freqs = np.array([f0])  # sweeps are S11-centric; keep NF light

        if _shared_substrate(variants):
            # fast path: one naked build + separable per-variant patch
            # stamps (equality vs the full path pinned in test_sweep.py)
            base, batched = _batched_coeffs_delta(
                variants, grid, feed_pos_mm, f0, fc, cfg,
                port_freqs, nf_freqs,
            )
        else:
            # general path: per-variant voxelize + coefficient builds are
            # independent; the heavy work (native containment core, large
            # numpy array math) releases the GIL, so threads give
            # near-linear prepare speedup (the reference re-prepares
            # serially per design)
            with ThreadPoolExecutor(max_workers=min(8, len(variants))) as tp:
                sims = list(tp.map(
                    lambda v: build_simulation(
                        _variant_scene(v, feed_pos_mm), grid, f0=f0, fc=fc,
                        cfg=cfg, port_freqs_hz=port_freqs, nf_freqs_hz=nf_freqs,
                    ),
                    variants,
                ))
            base = sims[0]
            batched = {
                k: jnp.stack([s.coeffs[k] for s in sims]) for k in base.coeffs
            }
        vrun = _make_vmapped_run(base)
        if verbose:
            print(
                f"sweep prepared: {len(variants)} variants on shared grid "
                f"{grid.shape} ({grid.num_cells} cells)"
            )
        return SweepPrepared(
            True,
            f"Sweep prepared: {len(variants)} variants, grid {grid.shape}",
            sim=base,
            batched_coeffs=batched,
            variants=variants,
            _vrun=vrun,
        )
    except Exception as e:
        return SweepPrepared(False, f"sweep prepare failed: {e}")


def _run_batched(prepared: SweepPrepared):
    """Execute the vmapped run; returns (out, wall_s, max_steps)."""
    import math

    sim = prepared.sim
    args = (
        prepared.batched_coeffs,
        jnp.asarray(sim.waveform),
        jnp.asarray(2 * math.pi * sim.port_freqs_hz, jnp.float32),
        jnp.asarray(2 * math.pi * sim.nf_freqs_hz, jnp.float32),
    )
    t0 = time.perf_counter()
    out = prepared._vrun(*args)
    jax.block_until_ready(out["steps"])
    wall = time.perf_counter() - t0
    return out, wall, int(np.max(_fetch(out["steps"])))



def _fetch(a) -> np.ndarray:
    """Device→host for arrays that may be sharded across *processes*: a
    plain np.asarray raises on non-fully-addressable arrays (the sweep
    axis spans hosts on a real pod), so gather them first. Single-process
    (incl. virtual CPU meshes) takes the cheap path."""
    if getattr(a, "is_fully_addressable", True):
        return np.asarray(a)
    from jax.experimental import multihost_utils  # pragma: no cover

    return np.asarray(multihost_utils.process_allgather(a))


def _batched_port_spectra(prepared: SweepPrepared, out) -> List[PortSpectra]:
    """Per-variant port-0 spectra from batched (B, 2, n_ports, Nf) DFTs."""
    sim = prepared.sim
    uf = _fetch(out["uf"])
    if_ = _fetch(out["if_"])
    return [
        port_spectra(
            sim.port_freqs_hz,
            uf[b, 0, 0] + 1j * uf[b, 1, 0],
            if_[b, 0, 0] + 1j * if_[b, 1, 0],
            sim.dft_dt,
        )
        for b in range(len(prepared.variants))
    ]


def run_patch_geometry_sweep(
    prepared: SweepPrepared, *, verbose: int = 0
) -> SweepResult:
    """Execute the batched sweep; per-variant S11 spectra and resonances."""
    try:
        if not prepared.ok or prepared.sim is None:
            return SweepResult(False, prepared.message)
        sim = prepared.sim
        out, wall, steps = _run_batched(prepared)
        n_var = len(prepared.variants)

        spectra = _batched_port_spectra(prepared, out)
        f_res, s11_min = [], []
        for sp, v in zip(spectra, prepared.variants):
            fr, _ = find_resonance(sp, v.frequency_hz)
            f_res.append(fr)
            s11_min.append(
                float(20 * np.log10(np.maximum(np.abs(sp.s11), 1e-30)).min())
            )
        rate = sim.grid.num_cells * steps * n_var / wall / 1e6
        if verbose:
            print(
                f"sweep: {n_var} variants × {steps} steps in {wall:.2f}s "
                f"→ {rate:.0f} Mcells/s aggregate"
            )
        return SweepResult(
            True,
            f"Sweep completed: {n_var} variants",
            spectra=spectra,
            f_res_hz=np.array(f_res),
            s11_min_db=np.array(s11_min),
            steps_run=steps,
            wall_time_s=wall,
            mcells_per_s=rate,
        )
    except Exception as e:
        return SweepResult(False, f"sweep run failed: {e}")


# ---------------------------------------------------------------------------
# Horn aperture sweeps (beyond-reference: the reference has no horn solver)
# ---------------------------------------------------------------------------

def prepare_horn_aperture_sweep(
    base,  # HornAntennaParams
    apertures_mm: Sequence,  # [(A_mm, B_mm, L_mm), ...]
    *,
    mesh_ppw: float = 15.0,
    n_steps_max: int = 16_000,
    end_criteria: float = 1e-4,
    boundary: str = "MUR",
    theta_step_deg: float = 5.0,
    phi_step_deg: float = 15.0,
    verbose: int = 0,
) -> SweepPrepared:
    """Batch N pyramidal-horn flare geometries into one vmapped program.

    All variants share the throat (a×b), waveguide and feed port — the
    port/probe layout is static across the batch — while the flare plates
    and aperture differ, which is purely a coefficient-array change on the
    shared grid. Sweeping (A, B, L) is the primary horn design loop
    (aperture ↔ gain tradeoff), run as ONE compiled program.
    """
    try:
        from ..models.scene import PEC, make_plate
        from .horn import horn_local_geometry

        apertures_mm = [tuple(map(float, ap)) for ap in apertures_mm]
        if not apertures_mm:
            return SweepPrepared(False, "No aperture variants provided.")
        variants = [
            dataclasses.replace(
                base,
                aperture_A_m=A * 1e-3,
                aperture_B_m=B * 1e-3,
                length_m=L * 1e-3,
            )
            for A, B, L in apertures_mm
        ]
        f0 = base.frequency_hz
        fc = f0 / 2.0
        mesh_res = C0 / (f0 + fc) / 1e-3 / mesh_ppw
        geos = [horn_local_geometry(v, mesh_res) for v in variants]
        g0 = geos[0]  # throat/waveguide/feed identical across variants
        lam0 = C0 / f0 * 1e3
        A_max = max(g["A"] for g in geos)
        B_max = max(g["B"] for g in geos)
        L_max = max(g["L"] for g in geos)
        m_xy = 0.75 * lam0

        mb = MeshBuilder()
        mb.add_line("x", [-A_max / 2 - m_xy, A_max / 2 + m_xy])
        mb.add_line("y", [-B_max / 2 - m_xy, B_max / 2 + m_xy])
        mb.add_line("z", [-g0["L_wg"] - g0["t"] - 0.5 * lam0,
                          L_max + 1.25 * lam0])
        for g in geos:  # union of every variant's feature lines
            for nm, vals in g["mesh_lines"].items():
                mb.add_line(nm, vals)
        grid = mb.build(mesh_res, ratio=1.4)

        cfg = FDTDConfig(
            n_steps_max=n_steps_max, end_criteria=end_criteria,
            boundary=boundary,
        )
        port_freqs = np.linspace(f0 * 0.7, f0 * 1.3, 201)
        nf_freqs = np.array([f0])

        def _scene(g):
            scene = Scene()
            for bi, (lo, hi) in enumerate(g["boxes"]):
                scene.add_metal_box(f"wg_{bi}", lo, hi, priority=10)
            pec = PEC("flare")
            for quad in g["quads"]:
                scene.add_polyhedron(make_plate(quad, g["t"], pec, priority=10))
            scene.add_lumped_port(
                1, 50.0, g["port_line"][0], g["port_line"][1],
                direction="y", excite=1.0,
            )
            return scene

        with ThreadPoolExecutor(max_workers=min(8, len(geos))) as tp:
            sims = list(tp.map(
                lambda g: build_simulation(
                    _scene(g), grid, f0=f0, fc=fc, cfg=cfg,
                    port_freqs_hz=port_freqs, nf_freqs_hz=nf_freqs,
                ),
                geos,
            ))
        base_sim = sims[0]
        batched = {
            k: jnp.stack([s.coeffs[k] for s in sims]) for k in base_sim.coeffs
        }
        vrun = _make_vmapped_run(base_sim)
        theta = np.arange(0.0, 181.0, max(0.5, theta_step_deg))
        phi = np.arange(0.0, 360.0, max(1.0, phi_step_deg))
        nf_centers = [
            np.array([0.0, 0.0, g["L"] / 2.0]) * 1e-3 for g in geos
        ]
        if verbose:
            print(
                f"horn sweep prepared: {len(variants)} apertures on shared "
                f"grid {grid.shape} ({grid.num_cells} cells)"
            )
        return SweepPrepared(
            True,
            f"Horn sweep prepared: {len(variants)} variants, grid {grid.shape}",
            sim=base_sim,
            batched_coeffs=batched,
            variants=variants,
            theta=theta,
            phi=phi,
            nf_centers=nf_centers,
            _vrun=vrun,
        )
    except Exception as e:
        return SweepPrepared(False, f"horn sweep prepare failed: {e}")


def run_horn_aperture_sweep(
    prepared: SweepPrepared, *, verbose: int = 0
) -> SweepResult:
    """Execute the batched horn sweep; per-variant S11 + boresight gain."""
    try:
        if not prepared.ok or prepared.sim is None:
            return SweepResult(False, prepared.message)
        from ..post.nf2ff import nf2ff_transform_batch

        sim = prepared.sim
        out, wall, steps = _run_batched(prepared)
        n_var = len(prepared.variants)

        spectra = _batched_port_spectra(prepared, out)
        f_res, s11_min = [], []
        for sp, v in zip(spectra, prepared.variants):
            fr, _ = find_resonance(sp, v.frequency_hz)
            f_res.append(fr)
            s11_min.append(
                float(20 * np.log10(np.maximum(np.abs(sp.s11), 1e-30)).min())
            )
        # nf_e / nf_h are per-face lists; vmap puts the batch axis at the
        # front of each face array — one batched NF2FF device program for
        # all variants × frequencies instead of a serial per-variant loop.
        # Slice to the REAL variant count: a sharded sweep pads the batch
        # axis (shard_sweep), and nf_centers has only n_var rows.
        nf_e = [_fetch(face)[:n_var] for face in out["nf_e"]]
        nf_h = [_fetch(face)[:n_var] for face in out["nf_h"]]
        ffs = nf2ff_transform_batch(
            sim.faces, nf_e, nf_h, sim.dft_dt, sim.nf_freqs_hz,
            prepared.theta, prepared.phi,
            centers_m=np.asarray(prepared.nf_centers),
        )
        dmax_dbi = [float(10 * np.log10(ff.Dmax[0])) for ff in ffs]
        rate = sim.grid.num_cells * steps * n_var / wall / 1e6
        if verbose:
            print(
                f"horn sweep: {n_var} apertures × {steps} steps in {wall:.2f}s"
                f" → {rate:.0f} Mcells/s aggregate; Dmax {dmax_dbi} dBi"
            )
        return SweepResult(
            True,
            f"Horn sweep completed: {n_var} variants",
            spectra=spectra,
            f_res_hz=np.array(f_res),
            s11_min_db=np.array(s11_min),
            Dmax_dbi=np.array(dmax_dbi),
            steps_run=steps,
            wall_time_s=wall,
            mcells_per_s=rate,
        )
    except Exception as e:
        return SweepResult(False, f"horn sweep run failed: {e}")
