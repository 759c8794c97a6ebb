"""N-port S-parameter matrix extraction (solvers/sparams.py).

The reference has no S-matrix capability at all (it drives every port in
phase, ``solver_fdtd_openems_microstrip_multi_3d.py:122-124``, and reads
S11 of the single feed only). These tests pin the beyond-reference
extractor to network-theory invariants on small scenes:

- a 1-port scene's S matrix equals the standard S11 path bit-for-bit
  (same machinery, same run);
- a geometrically symmetric 2-port is reciprocal (S12 = S21) and
  symmetric (S11 = S22), and roughly passive;
- flipping a port's polarity (its prepared ``excite`` sign) flips the
  off-diagonal phase but not any magnitude;
- ``restore=True`` puts the original excitation back.
"""

import numpy as np
import pytest

from fdtd_solver_antennas_tpu import compute_s_matrix
from fdtd_solver_antennas_tpu.models.scene import Scene
from fdtd_solver_antennas_tpu.ops.fdtd import (
    FDTDConfig,
    build_simulation,
    set_port_excitation,
)
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu.post.ports import port_spectra

FREQS = np.linspace(2.0e9, 3.0e9, 11)


def _scene_two_patches(pol2: float = 1.0):
    """Two identical small patches over one ground plane, port at each
    center. ``pol2`` sets port 2's prepared excitation (polarity)."""
    scene = Scene()
    scene.add_material_box("sub", 2.2, 0.0, [-30, -15, 0], [30, 15, 1.6], 0)
    scene.add_metal_box("gnd", [-30, -15, 0], [30, 15, 0], priority=10)
    for sgn, name in ((-1, "pa"), (+1, "pb")):
        cx = sgn * 13.0
        scene.add_metal_box(
            name, [cx - 6, -5, 1.6], [cx + 6, 5, 1.6], priority=10
        )
    scene.add_lumped_port(1, 50.0, [-13, 0, 0], [-13, 0, 1.6],
                          direction="z", excite=1.0)
    scene.add_lumped_port(2, 50.0, [13, 0, 0], [13, 0, 1.6],
                          direction="z", excite=pol2)
    mb = MeshBuilder()
    mb.add_line("x", np.linspace(-34, 34, 35))
    # feed lines AND patch edges exactly on mesh lines: an edge halfway
    # between lines snaps toward the lower index on both sides
    # (np.argmin tie-break), which would break the mirror symmetry this
    # test asserts
    mb.add_line("x", [-19.0, -13.0, -7.0, 7.0, 13.0, 19.0])
    mb.add_line("y", np.linspace(-19, 19, 20))
    mb.add_line("z", list(np.linspace(-8, 12, 11)) + [0.0, 0.8, 1.6])
    grid = mb.build(3.0)
    cfg = FDTDConfig(n_steps_max=3000, end_criteria=1e-5, check_every=500)
    sim = build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=FREQS, nf_freqs_hz=np.array([2.45e9]),
    )
    return sim


def _scene_one_patch():
    scene = Scene()
    scene.add_material_box("sub", 2.2, 0.0, [-15, -15, 0], [15, 15, 1.6], 0)
    scene.add_metal_box("gnd", [-15, -15, 0], [15, 15, 0], priority=10)
    scene.add_metal_box("p", [-6, -5, 1.6], [6, 5, 1.6], priority=10)
    scene.add_lumped_port(1, 50.0, [0, 0, 0], [0, 0, 1.6], direction="z")
    mb = MeshBuilder()
    mb.add_line("x", np.linspace(-19, 19, 20))
    mb.add_line("y", np.linspace(-19, 19, 20))
    mb.add_line("z", list(np.linspace(-8, 12, 11)) + [0.0, 0.8, 1.6])
    grid = mb.build(3.0)
    cfg = FDTDConfig(n_steps_max=3000, end_criteria=1e-5, check_every=500)
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=FREQS, nf_freqs_hz=np.array([2.45e9]),
    )


def test_single_port_matches_s11():
    sim = _scene_one_patch()
    out = sim.run()
    ref = port_spectra(FREQS, np.asarray(out["uf"])[0],
                       np.asarray(out["if_"])[0], sim.dt, z_ref=50.0)
    res = compute_s_matrix(sim)
    assert res.ok, res.message
    assert res.s.shape == (1, 1, len(FREQS))
    np.testing.assert_allclose(res.s[0, 0], ref.s11, rtol=1e-6, atol=1e-9)


def test_two_port_reciprocity_and_symmetry():
    sim = _scene_two_patches()
    res = compute_s_matrix(sim)
    assert res.ok, res.message
    s = res.s
    # mirror symmetry of the scene: the two ports are interchangeable
    np.testing.assert_allclose(s[0, 0], s[1, 1], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(s[0, 1], s[1, 0], rtol=2e-3, atol=1e-6)
    # reciprocity metric agrees
    assert res.reciprocity_error() < 5e-3 * np.nanmax(np.abs(s))
    # coupling exists but the network is (approximately) passive
    assert np.nanmax(np.abs(s[0, 1])) > 1e-4
    assert res.passivity_margin() < 1.05


def test_polarity_flip_changes_coupling_sign_only():
    s_pp = compute_s_matrix(_scene_two_patches(pol2=+1.0)).s
    s_pm = compute_s_matrix(_scene_two_patches(pol2=-1.0)).s
    # reflection terms are reference-sign invariant
    np.testing.assert_allclose(s_pm[0, 0], s_pp[0, 0], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(s_pm[1, 1], s_pp[1, 1], rtol=1e-5, atol=1e-9)
    # flipping port 2's reference flips the transmission sign
    np.testing.assert_allclose(s_pm[0, 1], -s_pp[0, 1], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(s_pm[1, 0], -s_pp[1, 0], rtol=1e-5, atol=1e-9)


def test_restore_reinstates_original_excitation():
    sim = _scene_two_patches()
    cols0 = [p.src_col.copy() for p in sim.ports]
    out0 = sim.run()
    res = compute_s_matrix(sim, restore=True)
    assert res.ok
    for p, c0 in zip(sim.ports, cols0):
        np.testing.assert_array_equal(p.src_col, c0)
    out1 = sim.run()
    np.testing.assert_allclose(
        np.asarray(out1["uf"]), np.asarray(out0["uf"]), rtol=1e-6, atol=1e-12
    )


def test_set_port_excitation_validates_length():
    sim = _scene_one_patch()
    with pytest.raises(ValueError):
        set_port_excitation(sim, [1.0, 0.0])


def test_s_matrix_is_one_compile(caplog):
    """Re-excitation must NOT re-trace or re-compile: the source
    matrices are runtime operands of the jitted run, which is what makes
    the array workflow physics-bound instead of compile-bound."""
    import logging

    import jax

    sim = _scene_two_patches()
    # identity check: re-excitation keeps the very same jitted objects
    host0 = sim._host_run
    sim.run()  # cold run: traces + compiles the program
    set_port_excitation(sim, [1.0, 0.0])
    assert sim._host_run is host0
    # compile-log check: every subsequent one-hot run hits the jit cache
    jax.config.update("jax_log_compiles", True)
    try:
        with caplog.at_level(logging.WARNING, logger="jax"):
            set_port_excitation(sim, [1.0, 0.0])
            out_a = sim.run()
            set_port_excitation(sim, [0.0, 1.0])
            out_b = sim.run()
        compiles = [
            r for r in caplog.records
            if "compil" in r.getMessage().lower()
        ]
        assert not compiles, [r.getMessage() for r in compiles]
    finally:
        jax.config.update("jax_log_compiles", False)
    # and the runs really did use different excitations
    assert not np.allclose(np.asarray(out_a["uf"]), np.asarray(out_b["uf"]))


def test_s_matrix_matches_rebuild_path():
    """The operand-swap re-excitation is numerically identical to a full
    run-fn rebuild (the pre-round-4 path)."""
    from fdtd_solver_antennas_tpu.ops.fdtd import rebuild_run_fn

    sim = _scene_two_patches()
    res = compute_s_matrix(sim)
    assert res.ok, res.message

    cols = []
    for j, one_hot in enumerate(([1.0, 0.0], [0.0, 1.0])):
        set_port_excitation(sim, one_hot)
        rebuild_run_fn(sim)  # force a fresh trace with the new sources
        out = sim.run()
        cols.append((np.asarray(out["uf"])[:2], np.asarray(out["if_"])[:2]))

    z = 50.0
    for j, (uf, if_) in enumerate(cols):
        a_j = 0.5 * (uf[j] + z * if_[j]) / np.sqrt(z)
        b = 0.5 * (uf - z * if_) / np.sqrt(z)
        np.testing.assert_allclose(
            res.s[:, j, :], b / a_j, rtol=1e-5, atol=1e-8
        )
