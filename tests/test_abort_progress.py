"""Run-progress + mid-flight abort hooks.

The reference's Streamlit abort flag could only stop a run from
*starting* (reference streamlit_app.py:165-168 — the C++ engine was
uninterruptible once launched). Our host-driven superchunk pipeline
(ops/fdtd.py:host_run) already pays one blocking host read per
superchunk, so ``progress_cb``/``abort_cb`` ride that sync point for
free: these tests pin the contract — monotone progress ticks, abort
within one superchunk, and an aborted run's state being a valid resume
checkpoint.
"""

import numpy as np
import pytest

from fdtd_solver_antennas_tpu.frontends.gui_app import format_progress
from fdtd_solver_antennas_tpu.frontends.webapp import BackgroundRun
from fdtd_solver_antennas_tpu.models.scene import Scene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder


def _build(n_steps, check_every=48):
    """Tiny patch scene on the host-driven (XLA) pipeline."""
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
        n_steps_max=n_steps, check_every=check_every, end_criteria=1e-30,
        probe_decimation=4,
    )
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, 5),
        nf_freqs_hz=np.array([2.45e9]),
    )


def test_progress_ticks_monotone_and_complete():
    # 3456 steps / chunk 48 (check_every 48, decim 4) / K_sub 32
    # → 2.25 → 3 superchunks → ≥3 ticks
    sim = _build(3456)
    ticks = []
    out = sim.run(progress_cb=lambda n, total, r: ticks.append((n, total, r)))
    assert int(out["steps"]) == 3456
    assert out["aborted"] is False
    assert len(ticks) >= 3
    steps_seen = [t[0] for t in ticks]
    assert steps_seen == sorted(steps_seen)
    assert steps_seen[-1] == 3456
    # energy ratios are finite and in (0, 1]
    for _, _, r in ticks:
        assert np.isfinite(r) and 0.0 < r <= 1.0
    # a final 100% tick is guaranteed
    n, total, _ = ticks[-1]
    assert n == total


def test_broken_progress_cb_does_not_kill_run():
    sim = _build(384)  # 8 exact chunks of 48

    def bad_cb(*a):
        raise RuntimeError("UI went away")

    out = sim.run(progress_cb=bad_cb)
    assert int(out["steps"]) == 384
    assert out["aborted"] is False


def test_abort_stops_within_one_superchunk():
    sim = _build(3456)
    out = sim.run(abort_cb=lambda: True)
    assert out["aborted"] is True
    steps = int(out["steps"])
    # stopped after the first superchunk (K_sub=32 chunks of 48 steps),
    # far short of the 3456-step budget
    assert 0 < steps <= 1536 < 3456


def test_aborted_state_is_a_valid_resume_checkpoint():
    ref = _build(3456).run()

    sim_a = _build(3456)
    ticks = []

    def abort_after_first_tick():
        return len(ticks) >= 1

    out_a = sim_a.run(
        progress_cb=lambda n, t, r: ticks.append(n),
        abort_cb=abort_after_first_tick,
    )
    assert out_a["aborted"] is True
    assert 0 < int(out_a["steps"]) < 3456

    sim_b = _build(3456)
    out_b = sim_b.run(resume_state=out_a["state"])
    assert int(out_b["steps"]) == 3456
    assert out_b["aborted"] is False
    np.testing.assert_allclose(
        np.asarray(out_b["uf"]), np.asarray(ref["uf"]), rtol=1e-5, atol=1e-12
    )


def test_format_progress():
    pct, text = format_progress(500, 2000, 3.2e-3)
    assert pct == 25.0
    assert "500/2000" in text and "25%" in text and "3.2e-03" in text
    # clamped, divide-by-zero safe
    assert format_progress(10, 0, 1.0)[0] == 100.0
    assert format_progress(0, 100, 1.0)[0] == 0.0


def test_background_run_progress_and_result():
    import time

    def fake_solver(x, *, progress_cb=None, abort_cb=None):
        for i in range(5):
            progress_cb(i + 1, 5, 1.0 / (i + 1))
            time.sleep(0.01)
        return x * 2

    run = BackgroundRun().start(fake_solver, 21)
    deadline = time.time() + 5.0
    while run.running and time.time() < deadline:
        time.sleep(0.01)
    assert not run.running
    assert run.error is None
    assert run.result == 42
    assert run.progress == (5, 5, pytest.approx(0.2))


def test_background_run_abort_and_error():
    import time

    def slow_solver(*, progress_cb=None, abort_cb=None):
        for i in range(200):
            if abort_cb():
                return "aborted"
            time.sleep(0.01)
        return "finished"

    run = BackgroundRun().start(slow_solver)
    run.abort()
    assert run.aborting
    deadline = time.time() + 5.0
    while run.running and time.time() < deadline:
        time.sleep(0.01)
    assert run.result == "aborted"

    def broken(*, progress_cb=None, abort_cb=None):
        raise ValueError("boom")

    run2 = BackgroundRun().start(broken)
    deadline = time.time() + 5.0
    while run2.running and time.time() < deadline:
        time.sleep(0.01)
    assert run2.error == "boom"
    assert run2.result is None


def test_background_run_drives_design_array():
    """The webapp Array tab's exact call path: BackgroundRun injects
    progress_cb/abort_cb kwargs into design_array — the signatures must
    stay compatible. Uses the tight-pitch guard so no FDTD runs."""
    import time

    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu.solvers.array_synth import design_array

    p = PatchAntennaParams.from_user_units(
        frequency_ghz=10.0, er=2.2, h_mm=0.787, loss_tangent=0.0009
    )
    run = BackgroundRun().start(design_array, p, 2, 1)
    deadline = time.time() + 30.0
    while run.running and time.time() < deadline:
        time.sleep(0.01)
    assert not run.running and run.error is None
    assert not run.result.ok and "increase the pitch" in run.result.message
