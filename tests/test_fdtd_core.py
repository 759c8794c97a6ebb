"""Engine correctness: golden comparison against an independent NumPy
stepper, stability, boundary behavior (SURVEY §4 test-pyramid plan)."""

import numpy as np
import pytest

from fdtd_solver_antennas_tpu.models.scene import Scene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder

from _numpy_reference import run_reference


def _small_sim(boundary="MUR", n_steps=60, with_substrate=True, check_every=None):
    mb = MeshBuilder()
    mb.add_line("x", [-30, 30, 0.0])
    mb.add_line("y", [-30, 30, 0.0])
    mb.add_line("z", [-20, 25])
    mb.add_line("z", np.linspace(0, 3.0, 3))
    grid = mb.build(5.0)
    scene = Scene()
    if with_substrate:
        scene.add_material_box(
            "sub", 3.0, 0.01, [-15, -15, 0], [15, 15, 3.0], priority=0
        )
        scene.add_metal_box("sheet", [-10, -8, 3.0], [10, 8, 3.0], priority=10)
        scene.add_metal_box("gnd", [-15, -15, 0.0], [15, 15, 0.0], priority=10)
    scene.add_lumped_port(1, 50.0, [0, 0, 0], [0, 0, 3.0], direction="z")
    cfg = FDTDConfig(
        n_steps_max=n_steps, check_every=check_every or n_steps,
        end_criteria=1e-12, boundary=boundary,
    )
    return build_simulation(
        scene, grid, f0=3e9, fc=1.5e9, cfg=cfg,
        port_freqs_hz=np.array([3e9]), nf_freqs_hz=np.array([3e9]),
        nf_margin_cells=2,
    )


@pytest.mark.parametrize("boundary", ["MUR", "PEC"])
def test_golden_vs_numpy_reference(boundary):
    """JAX engine fields must match the independent NumPy stepper."""
    n_steps = 60
    sim = _small_sim(boundary=boundary, n_steps=n_steps)
    out = sim.run()
    assert int(out["steps"]) == n_steps

    E_ref, H_ref = run_reference(sim, n_steps)
    names = ["Ex", "Ey", "Ez", "Hx", "Hy", "Hz"]
    ref = [E_ref["x"], E_ref["y"], E_ref["z"], H_ref["x"], H_ref["y"], H_ref["z"]]
    for name, got, want in zip(names, out["fields"], ref):
        got = np.asarray(got)
        scale = max(np.abs(want).max(), 1e-20)
        np.testing.assert_allclose(
            got, want, atol=2e-5 * scale, rtol=2e-4,
            err_msg=f"{name} mismatch vs NumPy reference",
        )


def test_stability_long_run():
    """No blow-up or NaN after many steps through a lossy structure."""
    sim = _small_sim(n_steps=2000, check_every=200)
    out = sim.run()
    for f in out["fields"]:
        arr = np.asarray(f)
        assert np.isfinite(arr).all()
    # source peak long past; fields decayed
    assert float(out["e_ratio"]) < 1e-2


def test_mur_absorbs_vacuum_pulse():
    """Radiated pulse leaves the box: energy ratio drops hard under MUR."""
    sim = _small_sim(
        boundary="MUR", n_steps=1500, with_substrate=False, check_every=150
    )
    out = sim.run()
    assert float(out["e_ratio"]) < 1e-4


def test_pec_box_traps_energy():
    """Closed PEC cavity keeps the energy bouncing (no absorption)."""
    sim = _small_sim(
        boundary="PEC", n_steps=1500, with_substrate=False, check_every=150
    )
    out = sim.run()
    # lossless cavity: late-time energy stays within ~2 orders of max
    assert float(out["e_ratio"]) > 1e-2


def test_early_exit_on_end_criteria():
    """EndCriteria semantics: loop stops once energy decays below it."""
    mb = MeshBuilder()
    mb.add_line("x", [-30, 30, 0.0])
    mb.add_line("y", [-30, 30, 0.0])
    mb.add_line("z", [-20, 25])
    mb.add_line("z", np.linspace(0, 3.0, 3))
    grid = mb.build(5.0)
    scene = Scene()
    scene.add_lumped_port(1, 50.0, [0, 0, 0], [0, 0, 3.0], direction="z")
    cfg = FDTDConfig(
        n_steps_max=5000, check_every=100, end_criteria=1e-3, boundary="MUR"
    )
    sim = build_simulation(
        scene, grid, f0=3e9, fc=1.5e9, cfg=cfg,
        port_freqs_hz=np.array([3e9]), nf_freqs_hz=np.array([3e9]),
        nf_margin_cells=2,
    )
    out = sim.run()
    assert int(out["steps"]) < 5000  # exited early
    assert float(out["e_ratio"]) < 1e-3


def test_zero_padding_is_physics_neutral():
    """pad_multiple must not change any result."""
    mb = MeshBuilder()
    mb.add_line("x", [-30, 30, 0.0])
    mb.add_line("y", [-30, 30, 0.0])
    mb.add_line("z", [-20, 25])
    mb.add_line("z", np.linspace(0, 3.0, 3))
    scene = Scene()
    scene.add_lumped_port(1, 50.0, [0, 0, 0], [0, 0, 3.0], direction="z")
    cfg = FDTDConfig(n_steps_max=100, check_every=100, end_criteria=1e-12)
    kw = dict(
        f0=3e9, fc=1.5e9, cfg=cfg,
        port_freqs_hz=np.array([2.5e9, 3e9]), nf_freqs_hz=np.array([3e9]),
        nf_margin_cells=2,
    )
    out_a = build_simulation(scene, mb.build(5.0), **kw).run()
    out_b = build_simulation(
        scene, mb.build(5.0), pad_multiple=(8, 4, 4), **kw
    ).run()
    np.testing.assert_allclose(out_a["uf"], out_b["uf"], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(out_a["if_"], out_b["if_"], rtol=1e-5, atol=1e-12)
    for a, b in zip(out_a["nf_e"], out_b["nf_e"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)


def test_final_chunk_overrun_continues_true_source():
    """When n_steps_max is not a multiple of the chunk size, the final
    chunk overruns; the overrun steps must inject the TRUE waveform
    continuation — neither replaying earlier samples via index clamping
    nor substituting zeros. (The waveform always covers the full source
    duration regardless of n_steps_max, so a small-budget run is a
    step-exact prefix of a larger-budget one — the property checkpoint
    resume depends on.)

    Equality oracle: run B (n_steps_max=90, chunk 60 → executes 120
    steps) must bit-match run A (n_steps_max=120 — same 120 steps, same
    source)."""
    def build(n_steps):
        mb = MeshBuilder()
        mb.add_line("x", [-30, 30, 0.0])
        mb.add_line("y", [-30, 30, 0.0])
        mb.add_line("z", [-20, 25])
        mb.add_line("z", np.linspace(0, 3.0, 3))
        scene = Scene()
        scene.add_lumped_port(1, 50.0, [0, 0, 0], [0, 0, 3.0], direction="z")
        cfg = FDTDConfig(
            n_steps_max=n_steps, check_every=60, end_criteria=1e-30,
            probe_decimation=2,
        )
        return build_simulation(
            scene, mb.build(5.0), f0=3e9, fc=1.5e9, cfg=cfg,
            port_freqs_hz=np.array([2.5e9, 3e9]), nf_freqs_hz=np.array([3e9]),
            nf_margin_cells=2,
        )

    sim_a = build(120)
    assert abs(sim_a.waveform[89]) > 1e-3, "source must still be active"
    out_a = sim_a.run()

    sim_b = build(90)
    assert sim_b.waveform.shape[0] >= 120, "waveform must cover the source"
    out_b = sim_b.run()
    assert int(out_a["steps"]) == int(out_b["steps"]) == 120

    for fa, fb in zip(out_a["fields"], out_b["fields"]):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    np.testing.assert_array_equal(
        np.asarray(out_a["uf"]), np.asarray(out_b["uf"])
    )


def _tiny_scene_grid(z_levels=None):
    mb = MeshBuilder()
    mb.add_line("x", [-30, 30, 0.0])
    mb.add_line("y", [-30, 30, 0.0])
    if z_levels is None:
        mb.add_line("z", [-20, 25])
        mb.add_line("z", np.linspace(0, 3.0, 3))
    else:
        mb.add_line("z", z_levels)
    return mb.build(5.0)


def test_port_on_grid_wall_rejected():
    """A lumped port flush against a transverse grid wall has no room
    for its Ampère current loop — the builder must reject it instead of
    letting a −1 gather index wrap to the opposite wall (silently wrong
    I(t)/Z/S11)."""
    grid = _tiny_scene_grid()
    scene = Scene()
    x0, y0 = grid.lines["x"][0], grid.lines["y"][0]
    scene.add_lumped_port(
        1, 50.0, [x0 * 1e3, y0 * 1e3, 0], [x0 * 1e3, y0 * 1e3, 3.0],
        direction="z",
    )
    cfg = FDTDConfig(n_steps_max=100)
    with pytest.raises(ValueError, match="grid boundary"):
        build_simulation(
            scene, grid, f0=3e9, fc=1.5e9, cfg=cfg,
            port_freqs_hz=np.array([3e9]), nf_freqs_hz=np.array([3e9]),
            nf_margin_cells=2,
        )
