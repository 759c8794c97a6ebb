"""Adjoint inverse design (solvers/inverse.py).

Beyond-reference capability (the reference explores designs only by
re-running the external engine per candidate). These tests pin the three
claims the module makes:

1. a binarized density of 1 reproduces the voxelizer's PEC sheet stamp
   exactly (so thresholded designs mean what the engine means by metal),
2. ``jax.grad`` of the S11-band loss matches finite differences through
   the full FDTD time loop, and
3. a few optimizer steps reduce the loss, and the binarized result can be
   validated through the standard engine run path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams
from fdtd_solver_antennas_tpu.models.scene import Scene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu.physics import substrate_conductivity
from fdtd_solver_antennas_tpu.solvers.inverse import (
    InverseDesignProblem,
    prepare_patch_inverse,
)


PARAMS = PatchAntennaParams.from_user_units(
    frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02
)


@pytest.fixture(scope="module")
def problem() -> InverseDesignProblem:
    # coarse, wide-band (fc = f0 halves the source length) test problem
    return prepare_patch_inverse(
        PARAMS,
        mesh_divisor=8.0,
        fc_hz=2.45e9,
        box_mm=(80.0, 80.0, 40.0),
        sub_mm=50.0,
        substrate_cells=2,
        n_steps_max_validate=4000,
    )


def test_region_resolves_on_mesh(problem):
    r = problem.region
    ni, nj = r.shape
    assert ni >= 2 and nj >= 2
    g = problem.sim.grid
    # the region edges are mesh lines by construction (prepare validates)
    assert 0 <= r.i0 < r.i1 < len(g.lines["x"])
    assert 0 <= r.j0 < r.j1 < len(g.lines["y"])


def test_full_density_matches_pec_stamp(problem):
    """rho ≡ 1 must equal the voxelizer stamping a metal sheet box over
    the region — same staggered cells zeroed, nothing else touched."""
    r = problem.region
    sim = problem.sim
    f0 = PARAMS.frequency_hz
    kappa = substrate_conductivity(f0, PARAMS.eps_r, PARAMS.loss_tangent)
    h = PARAMS.h_m * 1e3

    scene = Scene()
    scene.add_material_box(
        "substrate", PARAMS.eps_r, kappa,
        [-25.0, -25.0, 0.0], [25.0, 25.0, h], priority=0,
    )
    scene.add_metal_box(
        "gnd", [-25.0, -25.0, 0.0], [25.0, 25.0, 0.0], priority=10
    )
    scene.add_metal_box(
        "patch",
        [r.x_mm[0], r.y_mm[0], h], [r.x_mm[1], r.y_mm[1], h],
        priority=10,
    )
    scene.add_lumped_port(
        1, 50.0, [-6.0, 0.0, 0.0], [-6.0, 0.0, h], direction="z",
        excite=1.0,
    )
    ref = build_simulation(
        scene, sim.grid, f0=f0, fc=f0,
        cfg=FDTDConfig(n_steps_max=4000, boundary="MUR"),
        port_freqs_hz=np.asarray(sim.port_freqs_hz),
        nf_freqs_hz=np.asarray(sim.nf_freqs_hz),
    )
    got = problem.overlay_coeffs(jnp.ones(r.shape, jnp.float32))
    for name in ("ca_ex", "cb_ex", "ca_ey", "cb_ey", "ca_ez", "cb_ez"):
        np.testing.assert_array_equal(
            np.asarray(got[name]), np.asarray(ref.coeffs[name]),
            err_msg=name,
        )


def test_zero_density_is_identity(problem):
    got = problem.overlay_coeffs(jnp.zeros(problem.region.shape, jnp.float32))
    for name, base in problem.sim.coeffs.items():
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(base), err_msg=name)


@pytest.mark.slow
def test_gradient_matches_finite_difference(problem):
    rng = np.random.default_rng(7)
    rho = jnp.asarray(
        np.clip(0.5 + 0.1 * rng.standard_normal(problem.region.shape), 0, 1),
        jnp.float32,
    )
    loss = jax.jit(problem.loss)
    grad = jax.jit(jax.grad(problem.loss))(rho)
    assert np.isfinite(np.asarray(grad)).all()
    # probe the largest-|g| pixel with central differences
    g = np.asarray(grad)
    i, j = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 5e-2
    lp = float(loss(rho.at[i, j].add(+eps)))
    lm = float(loss(rho.at[i, j].add(-eps)))
    fd = (lp - lm) / (2 * eps)
    assert fd != 0.0
    assert abs(fd - g[i, j]) <= 0.05 * abs(fd) + 1e-8, (fd, g[i, j])


@pytest.mark.slow
def test_optimize_reduces_loss_and_validates(problem):
    res = problem.optimize(n_iters=3, lr=0.1)
    assert len(res.history) == 3
    assert res.history[-1] < res.history[0]
    assert np.isfinite(res.s11).all()
    val = problem.validate(res.rho)
    assert val["steps"] > 0
    assert set(val) >= {"spectra", "f_res_hz", "s11_db", "rho_binary"}
    # validate() must leave the base sim untouched
    got = np.asarray(problem.sim.coeffs["ca_ex"])
    r = problem.region
    base = problem.overlay_coeffs(jnp.zeros(r.shape, jnp.float32))
    np.testing.assert_array_equal(got, np.asarray(base["ca_ex"]))


def test_directivity_ri_matches_nf2ff(problem):
    """The traced far-field twin (_directivity_ri) must reproduce the
    validated NumPy transform (post/nf2ff.py) on the same inputs: random
    face accumulators, a θ×φ grid. Pins the pattern objective's math to
    the engine's standard NF2FF chain (the dt factor cancels in D)."""
    from fdtd_solver_antennas_tpu.post.nf2ff import nf2ff_transform
    from fdtd_solver_antennas_tpu.solvers.inverse import (
        _directivity_ri,
        _pattern_consts,
    )

    sim = problem.sim
    theta = np.arange(0.0, 91.0, 15.0)
    phi = np.array([0.0, 90.0])
    f0 = problem.f0
    from fdtd_solver_antennas_tpu.physics import ETA0

    rng = np.random.default_rng(3)
    face_e, face_h, nf_e, nf_h = [], [], [], []
    for f in sim.faces:
        nu, nv = f.u1 - f.u0, f.v1 - f.v0
        ae = rng.standard_normal((2, 2, nu, nv)).astype(np.float32)
        # outward-propagating local plane wave: H = (n̂ × E)/η0, so the
        # Poynting flux is positive on every face (a random independent
        # H would give P_rad ≤ 0, which the transform rightly NaNs).
        # With û×v̂ = s·n̂: n̂×û = s·v̂ and n̂×v̂ = −s·û.
        uh = np.zeros(3)
        uh[f.u_axis] = 1.0
        vh = np.zeros(3)
        vh[f.v_axis] = 1.0
        s = float(np.dot(np.cross(uh, vh), f.normal))
        ah = np.stack(
            [-s * ae[:, 1] / ETA0, s * ae[:, 0] / ETA0], axis=1
        ).astype(np.float32)
        face_e.append(jnp.asarray(ae))
        face_h.append(jnp.asarray(ah))
        # transform layout: (nf=1, 2 u/v, nu, nv) complex
        nf_e.append((ae[0] + 1j * ae[1])[None])
        nf_h.append((ah[0] + 1j * ah[1])[None])

    consts = _pattern_consts(sim.faces, theta, phi, f0)
    D, p_rad = _directivity_ri(consts, face_e, face_h)
    ff = nf2ff_transform(
        sim.faces, nf_e, nf_h, sim.dft_dt, np.array([f0]), theta, phi
    )
    assert float(p_rad) != 0.0
    np.testing.assert_allclose(
        np.asarray(D).reshape(len(theta), len(phi)),
        ff.directivity[0],
        rtol=2e-3,
        err_msg="traced directivity drifted from the NumPy NF2FF chain",
    )


@pytest.mark.slow
def test_broadside_gradient_matches_finite_difference(problem):
    """jax.grad of the broadside realized-gain loss — through the NF2FF
    radiation integrals AND the full FDTD time loop — must match central
    finite differences (VERDICT r4 next #9)."""
    rng = np.random.default_rng(11)
    rho = jnp.asarray(
        np.clip(0.5 + 0.1 * rng.standard_normal(problem.region.shape), 0, 1),
        jnp.float32,
    )
    loss = jax.jit(problem.broadside_gain_loss)
    grad = jax.jit(jax.grad(problem.broadside_gain_loss))(rho)
    assert np.isfinite(np.asarray(grad)).all()
    g = np.asarray(grad)
    i, j = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 5e-2
    lp = float(loss(rho.at[i, j].add(+eps)))
    lm = float(loss(rho.at[i, j].add(-eps)))
    fd = (lp - lm) / (2 * eps)
    assert fd != 0.0
    assert abs(fd - g[i, j]) <= 0.05 * abs(fd) + 1e-8, (fd, g[i, j])


@pytest.mark.slow
def test_optimize_broadside_lifts_gain(problem):
    """A few Adam steps on the broadside objective must increase the
    (soft-model) realized gain, and the binarized design must validate
    through the standard engine + NF2FF with finite broadside output."""
    res = problem.optimize(n_iters=3, lr=0.1, objective="broadside_gain")
    assert res.objective == "broadside_gain"
    # loss is NEGATIVE realized gain: it must decrease (gain rises)
    assert res.history[-1] < res.history[0]
    val = problem.validate(res.rho, pattern=True)
    assert val["broadside_directivity"] > 0.0
    assert np.isfinite(val["broadside_realized_gain_dbi"])
    assert np.isfinite(val["Dmax"]) and val["Dmax"] >= val[
        "broadside_directivity"
    ] - 1e-9
