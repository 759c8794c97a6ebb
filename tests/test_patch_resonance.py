"""FDTD-vs-analytical oracle test (the reference's validation pattern,
streamlit_app.py:339-344): a patch fed along its resonant dimension must
resonate where the cavity model says, and radiate a broadside pattern.

Runs a reduced-size scene so CPU CI stays fast; the full canonical scene is
exercised by chip_smoke.py and bench.py on the GPU.
"""

import numpy as np
import pytest

from fdtd_solver_antennas_tpu import PatchAntennaParams
from fdtd_solver_antennas_tpu.physics import (
    C0,
    design_patch_for_frequency,
    delta_L,
    effective_eps,
)
from fdtd_solver_antennas_tpu.solvers.patch_fixed import (
    prepare_patch_fixed,
    run_prepared_fixed,
)


@pytest.fixture(scope="module")
def patch_result():
    # Design for 2.45 GHz, then feed the TM10 (resonant) dimension along x.
    # The fixed-solver scene puts patch_width_m along x (tutorial
    # convention), so we pass the designed L as "W" to make x resonant.
    L_m, W_m, _ = design_patch_for_frequency(2.45e9, 4.3, 1.6e-3)
    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02,
        L_mm=W_m * 1e3, W_mm=L_m * 1e3,
    )
    prep = prepare_patch_fixed(params, n_steps_max=16000, verbose=0)
    assert prep.ok, prep.message
    res = run_prepared_fixed(prep, frequency_hz=2.45e9, verbose=0)
    assert res.ok, res.message
    return res


def _predicted_f_res() -> float:
    """Cavity-model resonance for the fed (x) dimension."""
    L_m, W_m, _ = design_patch_for_frequency(2.45e9, 4.3, 1.6e-3)
    eps_eff = effective_eps(4.3, 1.6e-3, W_m)
    L_eff = L_m + 2 * delta_L(eps_eff, 1.6e-3, W_m)
    return C0 / (2 * L_eff * np.sqrt(eps_eff))


def test_tm10_resonance_vs_cavity_model(patch_result):
    f_pred = _predicted_f_res()
    assert f_pred == pytest.approx(2.45e9, rel=0.01)  # design consistency
    # FDTD resonance within 4% of the cavity model (λ/20 mesh, MUR walls)
    assert patch_result.f_res_hz == pytest.approx(f_pred, rel=0.04)


def test_radiation_efficiency_reported(patch_result):
    # Loose sanity only: this fixture stops at EndCriteria 1e-4, so stored
    # resonator energy truncates P_rad. The rigorous frequency-by-frequency
    # power balance (η → 1 lossless) lives in test_power_balance.py.
    eta = patch_result.radiation_efficiency
    assert eta is not None
    assert 0.0 < eta <= 1.0


def test_s11_dip_depth(patch_result):
    s11_db = 20 * np.log10(np.maximum(np.abs(patch_result.s11), 1e-12))
    assert s11_db.min() < -8.0  # clear match at the probe position


def test_broadside_pattern(patch_result):
    inten = patch_result.intensity
    theta = np.rad2deg(patch_result.theta)
    # peak near broadside
    i_peak = int(np.argmax(inten[:, 0]))
    assert theta[i_peak] < 30.0
    # patch directivity in the physical range
    dmax_dbi = 10 * np.log10(patch_result.Dmax)
    assert 4.0 < dmax_dbi < 11.0
    # front-to-back ratio > 5 dB
    i0 = 0
    i180 = len(theta) - 1
    assert inten[i0, 0] - inten[i180, 0] > 5.0
