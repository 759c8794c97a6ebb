"""Checkpoint/resume: a run split into two segments (with an .npz round
trip between them) must reproduce the single uninterrupted run."""

import numpy as np
import pytest

from fdtd_solver_antennas_tpu.models.scene import Scene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu.post.checkpoint import load_state, save_state


def _build(n_steps):
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(5.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    cfg = FDTDConfig(
        n_steps_max=n_steps, check_every=100, end_criteria=1e-30,
        probe_decimation=4,
    )
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, 11),
        nf_freqs_hz=np.array([2.45e9]),
    )


@pytest.mark.parametrize("boundary_roundtrip", [True])
def test_resume_matches_straight_run(tmp_path, boundary_roundtrip):
    # straight 400-step run
    ref = _build(400).run()

    # segmented: 200 steps, checkpoint to disk, reload, continue to 400
    sim_a = _build(200)
    out_a = sim_a.run()
    assert int(out_a["steps"]) == 200
    ckpt = tmp_path / "state.npz"
    save_state(ckpt, out_a)

    sim_b = _build(400)
    out_b = sim_b.run(resume_state=load_state(ckpt))
    assert int(out_b["steps"]) == 400

    for fa, fb in zip(out_b["fields"], ref["fields"]):
        np.testing.assert_allclose(
            np.asarray(fa), np.asarray(fb), rtol=1e-5,
            atol=1e-6 * max(np.abs(np.asarray(fb)).max(), 1e-30),
        )
    np.testing.assert_allclose(
        np.asarray(out_b["uf"]), np.asarray(ref["uf"]), rtol=1e-5, atol=1e-12
    )
    for a, b in zip(out_b["nf_e"], ref["nf_e"]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5,
            atol=1e-6 * max(np.abs(np.asarray(b)).max(), 1e-30),
        )


def test_state_roundtrip_identity(tmp_path):
    sim = _build(100)
    out = sim.run()
    p = tmp_path / "s.npz"
    save_state(p, out)
    state = load_state(p)
    for i, f in enumerate(out["state"]["fields"]):
        np.testing.assert_array_equal(state["fields"][i], np.asarray(f))
    assert int(state["n"]) == 100


def test_resume_across_probe_decimation(tmp_path):
    """A checkpoint written at one probe decimation resumes correctly
    under another: the resumed DFT sums are rescaled by old/new cadence
    (post-processing multiplies the combined totals by the NEW dft_dt).
    Without the rescale the pre-checkpoint contribution is mis-weighted
    by the cadence ratio (a silent ~33% S11-amplitude error here)."""
    def build(n_steps, decim):
        mb = MeshBuilder()
        mb.add_line("x", [-40, 40, 0.0, -6.0])
        mb.add_line("y", [-40, 40, 0.0])
        mb.add_line("z", [-20, 30])
        mb.add_line("z", np.linspace(0, 1.6, 3))
        grid = mb.build(5.0)
        scene = Scene()
        scene.add_material_box(
            "sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
        scene.add_metal_box(
            "patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
        scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
        scene.add_lumped_port(
            1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
        cfg = FDTDConfig(
            n_steps_max=n_steps, check_every=120, end_criteria=1e-30,
            probe_decimation=decim,
        )
        return build_simulation(
            scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
            port_freqs_hz=np.linspace(2e9, 3e9, 11),
            nf_freqs_hz=np.array([2.45e9]),
        )

    # uninterrupted reference at the RESUMING cadence
    ref = build(720, 4).run()

    # leg A at decim 6 covers MOST of the run (so its mis-weighting
    # would dominate the integral), checkpoint, resume at decim 4
    out_a = build(600, 6).run()
    assert int(out_a["state"]["decim"]) == 6
    ckpt = tmp_path / "xdec.npz"
    save_state(ckpt, out_a)
    out_b = build(720, 4).run(resume_state=load_state(ckpt))
    assert int(out_b["steps"]) == int(ref["steps"])

    # the split run's DFT integral must approximate the uninterrupted
    # one; cadences differ over leg A, so allow a small decimation error
    # (the band-limited signal is heavily oversampled at both cadences)
    uf_b, uf_r = np.asarray(out_b["uf"]), np.asarray(ref["uf"])
    rel = np.abs(uf_b - uf_r).max() / np.abs(uf_r).max()
    assert rel < 0.02, f"cross-decimation resume uf rel err {rel:.3f}"
