"""Sweep-level device sharding (parallel/sweep_shard.py): sharded
sweeps must reproduce the unsharded sweep's results exactly.

Runs on the virtual 8-CPU mesh (tests/conftest.py). Covers:
- the pure "sweep" axis (the zero-collective layout that may span hosts);
- batch padding when variants don't divide the sweep axis;
- the composed ("sweep", "x") mesh — data parallel across sweep groups,
  spatial halos within each group.
"""

import numpy as np
import pytest

import jax

from fdtd_solver_antennas_tpu import PatchAntennaParams
from fdtd_solver_antennas_tpu.parallel.sweep_shard import (
    make_sweep_mesh,
    pad_batch,
    shard_sweep,
)
from fdtd_solver_antennas_tpu.solvers.sweep import (
    prepare_patch_geometry_sweep,
    run_patch_geometry_sweep,
)

GEOMS = [(26.0, 33.0), (28.0, 36.0), (30.0, 38.0), (32.0, 41.0)]
N_STEPS = 1500  # truncated: equality is what matters, not convergence


def _variants(n):
    return [
        PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, L_mm=L, W_mm=W
        )
        for (L, W) in GEOMS[:n]
    ]


def _run(n_var, mesh=None):
    prep = prepare_patch_geometry_sweep(_variants(n_var), n_steps_max=N_STEPS)
    assert prep.ok, prep.message
    if mesh is not None:
        shard_sweep(prep, mesh)
    res = run_patch_geometry_sweep(prep)
    assert res.ok, res.message
    return res


@pytest.fixture(scope="module")
def baseline():
    return _run(4)


def test_pad_batch():
    assert pad_batch(4, 4) == (4, 0)
    assert pad_batch(3, 4) == (4, 1)
    assert pad_batch(9, 4) == (12, 3)


def test_make_sweep_mesh_shapes():
    mesh = make_sweep_mesh(4, 2)
    assert mesh.axis_names == ("sweep", "x")
    assert mesh.devices.shape == (4, 2)
    with pytest.raises(ValueError):
        make_sweep_mesh(3, 2)  # 6 != 8 devices


@pytest.mark.slow
def test_sweep_axis_equality(baseline):
    """4 variants over a 4-device sweep axis == unsharded."""
    mesh = make_sweep_mesh(4, 2)
    res = _run(4, mesh)
    for sp_s, sp_u in zip(res.spectra, baseline.spectra):
        np.testing.assert_allclose(
            np.abs(sp_s.s11), np.abs(sp_u.s11), rtol=1e-4, atol=1e-6
        )
    np.testing.assert_allclose(res.f_res_hz, baseline.f_res_hz)


@pytest.mark.slow
def test_sweep_padding_equality():
    """3 variants padded onto a 4-way sweep axis: padded row is ignored
    and the 3 real variants match the unsharded 3-variant run (same
    union grid — a 4-variant baseline would mesh differently)."""
    mesh = make_sweep_mesh(4, 2)
    res = _run(3, mesh)
    ref = _run(3)
    assert len(res.spectra) == 3
    for sp_s, sp_u in zip(res.spectra, ref.spectra):
        np.testing.assert_allclose(
            np.abs(sp_s.s11), np.abs(sp_u.s11), rtol=1e-4, atol=1e-6
        )


@pytest.mark.slow
def test_sweep_times_spatial_equality(baseline):
    """(sweep=2, x=4) composed mesh: each variant group spatially sharded."""
    mesh = make_sweep_mesh(2, 4)
    res = _run(4, mesh)
    for sp_s, sp_u in zip(res.spectra, baseline.spectra):
        np.testing.assert_allclose(
            np.abs(sp_s.s11), np.abs(sp_u.s11), rtol=1e-4, atol=1e-6
        )


def test_sharded_inputs_actually_sharded():
    """The coefficient stacks really live distributed on the mesh."""
    mesh = make_sweep_mesh(4, 2)
    prep = prepare_patch_geometry_sweep(_variants(4), n_steps_max=N_STEPS)
    shard_sweep(prep, mesh)
    arr = next(v for v in prep.batched_coeffs.values() if v.ndim == 4)
    assert len(arr.sharding.device_set) == 8
    # batch axis split 4-way, x axis 2-way
    shard_shape = arr.sharding.shard_shape(arr.shape)
    assert shard_shape[0] == arr.shape[0] // 4
    assert shard_shape[1] < arr.shape[1]


@pytest.mark.slow
def test_horn_sweep_padding_equality():
    """Regression: a sharded HORN sweep whose batch pads onto the sweep
    axis must slice the padded NF2FF face accumulators back to the real
    variant count before the batched transform (the nf_centers table has
    only n_var rows — this crashed with a reshape error before)."""
    from fdtd_solver_antennas_tpu.models.params import HornAntennaParams
    from fdtd_solver_antennas_tpu.solvers.sweep import (
        prepare_horn_aperture_sweep,
        run_horn_aperture_sweep,
    )

    base = HornAntennaParams.from_user_units(
        frequency_ghz=12.0, throat_a_mm=19.05, throat_b_mm=9.525,
        aperture_A_mm=48.0, aperture_B_mm=36.0, length_mm=40.0,
    )
    apertures = [(30.0, 24.0, 30.0), (40.0, 30.0, 36.0), (55.0, 42.0, 45.0)]

    def run(mesh=None):
        prep = prepare_horn_aperture_sweep(
            base, apertures, mesh_ppw=10.0, n_steps_max=2500,
        )
        assert prep.ok, prep.message
        if mesh is not None:
            shard_sweep(prep, mesh)
            assert prep._sweep_pad == 1  # 3 variants on a 4-way axis
        res = run_horn_aperture_sweep(prep)
        assert res.ok, res.message
        return res

    ref = run()
    res = run(make_sweep_mesh(4, 2))
    assert len(res.spectra) == 3 and res.Dmax_dbi.shape == (3,)
    np.testing.assert_allclose(res.Dmax_dbi, ref.Dmax_dbi, rtol=1e-4)
    for sp_s, sp_u in zip(res.spectra, ref.spectra):
        np.testing.assert_allclose(
            np.abs(sp_s.s11), np.abs(sp_u.s11), rtol=1e-4, atol=1e-6
        )
