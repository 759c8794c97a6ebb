"""The XLA leapfrog step on the scenes that matter for the GPU port:
mixed-axis ports, tall (z > 128) grids, CPML and many-port arrays.

Scenes the NumPy reference stepper covers (lumped ports, MUR or PEC) are
checked field for field against it; CPML and nine-port scenes, which it
does not cover, are checked for finiteness, decay and distinct spectra.
"""

import numpy as np
import pytest

from fdtd_solver_antennas_tpu.models.scene import Scene
from fdtd_solver_antennas_tpu.ops.fdtd import (
    FDTDConfig,
    build_simulation,
    n_probe_rows,
)
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder

from _numpy_reference import run_reference


def _patch_scene(scene=None):
    scene = scene or Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    return scene


def _build(scene, grid, n_steps, boundary="MUR", n_freqs=7):
    cfg = FDTDConfig(
        n_steps_max=n_steps, check_every=n_steps, end_criteria=1e-30,
        boundary=boundary, probe_decimation=4,
    )
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, n_freqs),
        nf_freqs_hz=np.array([2.45e9]),
    )


def _assert_matches_reference(sim, n_steps):
    out = sim.run()
    assert int(out["steps"]) == n_steps
    E_ref, H_ref = run_reference(sim, n_steps)
    ref = [E_ref["x"], E_ref["y"], E_ref["z"],
           H_ref["x"], H_ref["y"], H_ref["z"]]
    # scale every component's atol by the global field magnitude: a
    # component that is pure numerical residue (e.g. Hz under a z-port in
    # a symmetric scene) must not trip on float32 noise
    e_scale = max(float(np.abs(r).max()) for r in ref[:3])
    h_scale = max(float(np.abs(r).max()) for r in ref[3:])
    for name, got, want, scale in zip(
        ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"), out["fields"], ref,
        (e_scale,) * 3 + (h_scale,) * 3,
    ):
        np.testing.assert_allclose(
            np.asarray(got), want, rtol=2e-4, atol=2e-5 * scale,
            err_msg=f"{name} mismatch vs NumPy reference",
        )
    return out


def _patch_grid():
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    return mb.build(5.0)


@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_patch_scene_matches_reference(boundary):
    """The canonical-style patch (substrate, sheet metal, z-port) with
    MUR or PEC walls."""
    sim = _build(_patch_scene(), _patch_grid(), 120, boundary=boundary)
    _assert_matches_reference(sim, 120)


def test_two_ports_on_mixed_axes_match_reference():
    """A z-port and an x-port: two source-matrix components and two
    probe rows on different axes."""
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0, 10.0, 18.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30, 5.0])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    scene = _patch_scene()
    scene.add_lumped_port(2, 50.0, [10, 0, 5], [18, 0, 5], direction="x")
    sim = _build(scene, grid, 120)
    assert n_probe_rows(sim) == 2
    out = _assert_matches_reference(sim, 120)
    uf = np.asarray(out["uf"])
    assert np.isfinite(uf).all() and np.abs(uf[1]).max() > 0


def test_tall_grid_matches_reference():
    """A grid with more than 128 z nodes takes the same step."""
    mb = MeshBuilder()
    mb.add_line("x", [-30, 30, 0.0, -6.0])
    mb.add_line("y", [-30, 30, 0.0])
    mb.add_line("z", np.linspace(-40, 56, 140))
    grid = mb.build(8.0)
    assert grid.shape[2] > 128
    sim = _build(_patch_scene(), grid, 60)
    _assert_matches_reference(sim, 60)


def test_pml_run_is_finite_and_decays():
    """CPML walls absorb a radiated pulse: fields stay finite and the
    energy ratio falls far below its peak, unlike a closed PEC box."""
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-30, 35])
    mb.add_line("z", np.linspace(0, 3.0, 3))
    grid = mb.build(5.0)
    scene = Scene()
    scene.add_lumped_port(1, 50.0, [0, 0, 0], [0, 0, 3.0], direction="z")
    cfg = FDTDConfig(n_steps_max=1500, check_every=150, end_criteria=1e-30,
                     boundary="PML_4")
    sim = build_simulation(
        scene, grid, f0=3e9, fc=1.5e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 4e9, 5),
        nf_freqs_hz=np.array([3e9]), nf_margin_cells=2,
    )
    out = sim.run()
    for f in out["fields"]:
        assert np.isfinite(np.asarray(f)).all()
    for psi in out["state"]["psi_e"].values():
        assert np.isfinite(np.asarray(psi)).all()
    assert np.isfinite(np.asarray(out["uf"])).all()
    assert float(out["e_ratio"]) < 1e-3


def test_nine_port_array_rows_are_finite_and_distinct():
    """A 3×3 array of small patches, one z-port each: nine probe rows,
    all finite and driven, and the centre element (four neighbours) sees
    a different spectrum from a corner element (two)."""
    mb = MeshBuilder()
    mb.add_line("x", np.linspace(-40, 40, 33))
    mb.add_line("y", np.linspace(-40, 40, 33))
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(6.0)
    scene = Scene()
    scene.add_material_box("sub", 2.2, 0.0, [-38, -38, 0], [38, 38, 1.6], 0)
    scene.add_metal_box("gnd", [-38, -38, 0], [38, 38, 0], priority=10)
    pid = 0
    for iy in (-1, 0, 1):
        for ix in (-1, 0, 1):
            cx, cy = 22.0 * ix, 22.0 * iy
            pid += 1
            scene.add_metal_box(
                f"p{pid}", [cx - 7, cy - 6, 1.6], [cx + 7, cy + 6, 1.6],
                priority=10,
            )
            scene.add_lumped_port(
                pid, 50.0, [cx, cy, 0], [cx, cy, 1.6], direction="z"
            )
    sim = _build(scene, grid, 400, n_freqs=5)
    assert n_probe_rows(sim) == 9
    out = sim.run()
    uf, if_ = np.asarray(out["uf"]), np.asarray(out["if_"])
    assert uf.shape[0] == 9
    assert np.isfinite(uf).all() and np.isfinite(if_).all()
    assert (np.abs(uf).max(axis=1) > 0).all()
    z_in = uf / if_
    assert not np.allclose(z_in[4], z_in[0], rtol=1e-3)
