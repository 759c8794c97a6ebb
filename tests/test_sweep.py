"""Vmapped geometry sweep: batched designs in one compiled program.

Physics check: each variant's S11 must dip near the cavity-model
prediction for its fed (x-axis) dimension, and the dips must order
inversely with patch size.
"""

import numpy as np
import pytest

from fdtd_solver_antennas_tpu import PatchAntennaParams
from fdtd_solver_antennas_tpu.physics import C0, delta_L, effective_eps
from fdtd_solver_antennas_tpu.solvers.sweep import (
    prepare_patch_geometry_sweep,
    run_patch_geometry_sweep,
)

GEOMS = [(26.0, 33.0), (32.0, 41.0)]  # (L_mm, W_mm); W is the fed x-dim


def _predicted(w_mm: float) -> float:
    w = w_mm * 1e-3
    eps_eff = effective_eps(4.3, 1.6e-3, w)
    w_eff = w + 2 * delta_L(eps_eff, 1.6e-3, w)
    return C0 / (2 * w_eff * np.sqrt(eps_eff))


@pytest.fixture(scope="module")
def sweep_result():
    variants = [
        PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, L_mm=L, W_mm=W
        )
        for (L, W) in GEOMS
    ]
    prep = prepare_patch_geometry_sweep(variants, n_steps_max=6000)
    assert prep.ok, prep.message
    res = run_patch_geometry_sweep(prep)
    assert res.ok, res.message
    return variants, prep, res


@pytest.mark.slow
def test_sweep_shapes(sweep_result):
    variants, prep, res = sweep_result
    assert len(res.spectra) == len(GEOMS)
    assert np.isfinite(res.s11_min_db).all()


@pytest.mark.slow
def test_sweep_resonances_near_cavity_model(sweep_result):
    """Each variant dips within 8% of its cavity-model fundamental."""
    variants, prep, res = sweep_result
    dips = []
    for (L, W), sp in zip(GEOMS, res.spectra):
        f_pred = _predicted(W)
        db = 20 * np.log10(np.abs(sp.s11) + 1e-30)
        win = (sp.freq_hz > 0.85 * f_pred) & (sp.freq_hz < 1.15 * f_pred)
        assert win.any(), f"prediction {f_pred / 1e9:.2f} GHz out of band"
        i = np.argmin(np.where(win, db, 0.0))
        f_dip = sp.freq_hz[i]
        assert db[i] < -8.0
        assert f_dip == pytest.approx(f_pred, rel=0.08)
        dips.append(f_dip)
    # bigger patch → lower resonance
    assert dips[0] > dips[1]


def test_sweep_validation():
    assert not prepare_patch_geometry_sweep([]).ok
    a = PatchAntennaParams.from_user_units(frequency_ghz=2.45, er=4.3, h_mm=1.6)
    b = PatchAntennaParams.from_user_units(frequency_ghz=2.45, er=4.3, h_mm=0.8)
    prep = prepare_patch_geometry_sweep([a, b])
    assert not prep.ok
    assert "substrate thickness" in prep.message


def test_vmapped_sweep_matches_sequential_runs():
    """The vmapped sweep (one compiled program, coefficients as batched
    runtime operands of the traced run) must reproduce each variant run
    on its own through the standard host pipeline on the same union
    grid. This also guards the silent-broadcast failure mode:
    coefficients baked in as compile-time constants would give every
    variant variant 0's geometry."""
    from fdtd_solver_antennas_tpu.ops.fdtd import build_simulation
    from fdtd_solver_antennas_tpu.solvers.sweep import _variant_scene

    variants = [
        PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, L_mm=L, W_mm=W
        )
        for (L, W) in GEOMS
    ]
    prep = prepare_patch_geometry_sweep(
        variants, n_steps_max=400, end_criteria=1e-12
    )
    assert prep.ok, prep.message
    res = run_patch_geometry_sweep(prep)
    assert res.ok, res.message

    base = prep.sim
    for v, sp in zip(variants, res.spectra):
        sim = build_simulation(
            _variant_scene(v, -6.0), base.grid, f0=base.f0, fc=base.fc,
            cfg=base.cfg, port_freqs_hz=base.port_freqs_hz,
            nf_freqs_hz=base.nf_freqs_hz,
        )
        out = sim.run()
        assert int(out["steps"]) == res.steps_run
        uf = np.asarray(out["uf"])[0] * sim.dft_dt  # PortSpectra scaling
        np.testing.assert_allclose(
            sp.uf, uf, rtol=2e-3, atol=2e-4 * np.abs(uf).max())
    s0 = np.abs(res.spectra[0].s11)
    s1 = np.abs(res.spectra[1].s11)
    assert not np.allclose(s0, s1, rtol=1e-3)


# --- horn aperture sweep (beyond-reference) --------------------------------

@pytest.fixture(scope="module")
def horn_sweep_result():
    from fdtd_solver_antennas_tpu.models.params import HornAntennaParams
    from fdtd_solver_antennas_tpu.solvers.sweep import (
        prepare_horn_aperture_sweep,
        run_horn_aperture_sweep,
    )

    base = HornAntennaParams.from_user_units(
        frequency_ghz=12.0, throat_a_mm=19.05, throat_b_mm=9.525,
        aperture_A_mm=48.0, aperture_B_mm=36.0, length_mm=40.0,
    )
    # small vs large aperture: gain must increase with aperture area
    apertures = [(30.0, 24.0, 30.0), (55.0, 42.0, 45.0)]
    prep = prepare_horn_aperture_sweep(
        base, apertures, mesh_ppw=11.0, n_steps_max=5000,
    )
    assert prep.ok, prep.message
    res = run_horn_aperture_sweep(prep)
    assert res.ok, res.message
    return apertures, res


@pytest.mark.slow
def test_horn_sweep_shapes(horn_sweep_result):
    apertures, res = horn_sweep_result
    assert len(res.spectra) == 2
    assert res.Dmax_dbi.shape == (2,)
    assert np.isfinite(res.Dmax_dbi).all()
    assert np.isfinite(res.s11_min_db).all()


@pytest.mark.slow
def test_horn_sweep_gain_grows_with_aperture(horn_sweep_result):
    """Aperture theory: D ∝ A·B (for fixed efficiency) — the larger
    aperture must show several dB more directivity."""
    apertures, res = horn_sweep_result
    assert res.Dmax_dbi[1] > res.Dmax_dbi[0] + 2.0
    # both within a sane horn range
    assert 5.0 < res.Dmax_dbi[0] < 20.0
    assert 8.0 < res.Dmax_dbi[1] < 22.0


def test_delta_coeffs_match_full_build():
    """The naked-base + separable-patch-stamp fast path must reproduce the
    per-variant ``build_simulation`` coefficient arrays bitwise (it is the
    default sweep path whenever variants share the substrate)."""
    from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
    from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder
    from fdtd_solver_antennas_tpu.physics import C0 as _C0
    from fdtd_solver_antennas_tpu.solvers.sweep import (
        _batched_coeffs_delta,
        _patch_dims_mm,
        _shared_substrate,
        _variant_scene,
    )

    variants = [
        PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02,
            L_mm=L, W_mm=W,
        )
        for (L, W) in [(26.0, 33.0), (29.0, 37.0), (32.0, 41.0)]
    ]
    assert _shared_substrate(variants)
    f0 = 2.45e9
    fc = f0 / 2
    mesh_res = _C0 / (f0 + fc) / 1e-3 / 12.0  # coarse: keep the test fast
    h = 1.6
    mb = MeshBuilder()
    mb.add_line("x", [-60.0, 60.0])
    mb.add_line("y", [-60.0, 60.0])
    mb.add_line("z", [-30.0, 60.0])
    mb.add_line("z", np.linspace(0.0, h, 5))
    mb.add_line("x", [-6.0])
    mb.add_line("y", [0.0])
    for v in variants:
        W, L = _patch_dims_mm(v)
        mb.add_metal_edges([-W / 2, -L / 2, h], [W / 2, L / 2, h], dirs="xy")
    grid = mb.build(mesh_res, ratio=1.4)

    cfg = FDTDConfig(n_steps_max=500, end_criteria=1e-4)
    pf = np.linspace(1.5e9, 3.5e9, 21)
    nf = np.array([f0])
    _, batched = _batched_coeffs_delta(
        variants, grid, -6.0, f0, fc, cfg, pf, nf
    )
    for b, v in enumerate(variants):
        full = build_simulation(
            _variant_scene(v, -6.0), grid, f0=f0, fc=fc, cfg=cfg,
            port_freqs_hz=pf, nf_freqs_hz=nf,
        )
        for k in full.coeffs:
            got = np.asarray(batched[k][b])
            want = np.asarray(full.coeffs[k])
            assert got.shape == want.shape, (k, got.shape, want.shape)
            assert np.array_equal(got, want), (
                f"variant {b} key {k}: {np.abs(got - want).max()} max diff"
            )
