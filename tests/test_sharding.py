"""Multi-chip correctness: sharded execution must reproduce the
single-device run (SURVEY §4: sharded vs single-chip field evolution to
tight tolerance, on a virtual CPU mesh)."""

import numpy as np

import jax

from fdtd_solver_antennas_tpu.models.scene import Scene
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu.ops.mesh import MeshBuilder
from fdtd_solver_antennas_tpu.parallel.sharding import (
    make_device_mesh,
    shard_simulation,
)


def _build(pad_x=1, pad_y=1, n_steps=300):
    mb = MeshBuilder()
    mb.add_line("x", [-40, 40, 0.0, -6.0])
    mb.add_line("y", [-40, 40, 0.0])
    mb.add_line("z", [-20, 30])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(4.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    cfg = FDTDConfig(n_steps_max=n_steps, check_every=100, end_criteria=1e-12)
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, 21),
        nf_freqs_hz=np.array([2.45e9]),
        pad_multiple=(pad_x, pad_y, 1),
    )


def test_eight_device_mesh_available():
    assert len(jax.devices()) >= 8  # conftest forces 8 virtual CPU devices


def test_sharded_matches_single_device():
    n_dev = 8
    ref = _build(pad_x=n_dev).run()

    sim = _build(pad_x=n_dev)
    mesh = make_device_mesh((n_dev,), ("x",))
    shard_simulation(sim, mesh)
    got = sim.run()

    def close(a, b, rtol=1e-3):
        a, b = np.asarray(a), np.asarray(b)
        # float32 + SPMD reduction reordering → scale-aware tolerance
        atol = 1e-4 * max(np.abs(b).max(), 1e-20)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)

    assert int(got["steps"]) == int(ref["steps"])
    close(got["uf"], ref["uf"])
    close(got["if_"], ref["if_"])
    for a, b in zip(got["nf_e"], ref["nf_e"]):
        close(a, b)
    for fa, fb in zip(got["fields"], ref["fields"]):
        close(fa, fb)


def _build_pml(pad_x=1, n_steps=200):
    mb = MeshBuilder()
    mb.add_line("x", [-60, 60, 0.0, -6.0])
    mb.add_line("y", [-60, 60, 0.0])
    mb.add_line("z", [-40, 50])
    mb.add_line("z", np.linspace(0, 1.6, 3))
    grid = mb.build(4.0)
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [-20, -20, 0], [20, 20, 1.6], 0)
    scene.add_metal_box("patch", [-15, -12, 1.6], [15, 12, 1.6], priority=10)
    scene.add_metal_box("gnd", [-20, -20, 0], [20, 20, 0], priority=10)
    scene.add_lumped_port(1, 50.0, [-6, 0, 0], [-6, 0, 1.6], direction="z")
    cfg = FDTDConfig(
        n_steps_max=n_steps, check_every=100, end_criteria=1e-12,
        boundary="PML_8",
    )
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, 21),
        nf_freqs_hz=np.array([2.45e9]),
        pad_multiple=(pad_x, 1, 1),
    )


def _close_explicit(a, b, rtol=1e-3):
    a, b = np.asarray(a), np.asarray(b)
    if a.ndim == 3 and a.shape != b.shape:
        sl = tuple(slice(0, min(x, y)) for x, y in zip(a.shape, b.shape))
        a, b = a[sl], b[sl]
    atol = 1e-4 * max(np.abs(b).max(), 1e-20)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_explicit_collectives_match_single_device():
    """The hand-scheduled shard_map + ppermute path must reproduce the
    single-device XLA run (SURVEY §2.3: explicit halo exchange over the
    mesh axis; probe DFTs reduced by one final psum)."""
    from fdtd_solver_antennas_tpu.parallel.explicit import build_explicit_run

    ref = _build(pad_x=8).run()
    sim = _build(pad_x=8)
    mesh = make_device_mesh((8,), ("x",))
    got = build_explicit_run(sim, mesh)()

    assert int(got["steps"]) == int(ref["steps"])
    _close_explicit(got["uf"], ref["uf"])
    _close_explicit(got["if_"], ref["if_"])
    for a, b in zip(got["nf_e"], ref["nf_e"]):
        _close_explicit(a, b)
    for fa, fb in zip(got["fields"], ref["fields"]):
        _close_explicit(fa, fb)


def test_explicit_collectives_pml():
    """Explicit path under CPML: ψ recursions are elementwise given the
    halo-extended derivatives, so the sharded run must still match."""
    from fdtd_solver_antennas_tpu.parallel.explicit import build_explicit_run

    ref = _build_pml(pad_x=8).run()
    sim = _build_pml(pad_x=8)
    mesh = make_device_mesh((8,), ("x",))
    got = build_explicit_run(sim, mesh)()
    assert int(got["steps"]) == int(ref["steps"])
    _close_explicit(got["uf"], ref["uf"])
    for a, b in zip(got["nf_e"], ref["nf_e"]):
        _close_explicit(a, b)
    for fa, fb in zip(got["fields"], ref["fields"]):
        _close_explicit(fa, fb)


def test_two_axis_mesh():
    """2D spatial decomposition (x × y) also reproduces the reference."""
    ref = _build(pad_x=4, pad_y=2).run()
    sim = _build(pad_x=4, pad_y=2)
    mesh = make_device_mesh((4, 2), ("x", "y"))
    shard_simulation(sim, mesh)
    got = sim.run()
    np.testing.assert_allclose(
        np.asarray(got["uf"]), np.asarray(ref["uf"]), rtol=1e-4, atol=1e-12
    )


def test_explicit_resume_matches_uninterrupted():
    """Multi-chip checkpoint/resume (SURVEY §5 extended): a run split at
    a chunk boundary and resumed — including a cross-path resume from a
    SINGLE-CHIP checkpoint into the sharded run — must match the
    uninterrupted sharded run (fields, port and NF2FF DFT accumulators).
    Resumed DFT totals are added after the final psum (partial-sum
    linearity), which this pins down."""
    from fdtd_solver_antennas_tpu.parallel.explicit import build_explicit_run

    mesh = make_device_mesh((8,), ("x",))
    ref = build_explicit_run(_build(pad_x=8), mesh)()

    # leg 1: single-chip XLA run to the first chunk boundary (100 steps)
    sim_a = _build(pad_x=8, n_steps=100)
    out_a = sim_a.run()
    steps_a = int(out_a["steps"])  # chunk-rounded past 100
    assert 100 <= steps_a < int(ref["steps"])

    # leg 2: resume the sharded run from the single-chip checkpoint
    sim_b = _build(pad_x=8)
    out_b = build_explicit_run(sim_b, mesh)(resume_state=out_a["state"])
    assert int(out_b["steps"]) == int(ref["steps"])

    _close_explicit(out_b["uf"], ref["uf"])
    _close_explicit(out_b["if_"], ref["if_"])
    for a, b in zip(out_b["nf_e"], ref["nf_e"]):
        _close_explicit(a, b)
    for fa, fb in zip(out_b["fields"], ref["fields"]):
        _close_explicit(fa, fb)
    # and the output state round-trips as a valid checkpoint
    assert out_b["state"]["fields"][0].shape == tuple(
        sim_b.padded_shape or sim_b.grid.shape)


def _build_straddle(n_steps=300, boundary="MUR"):
    """25 x-lines padded to 32 over 8 devices: 4 rows per shard, so the
    top MUR x-face (row 24) sits exactly on a shard boundary."""
    mb = MeshBuilder()
    mb.add_line("x", np.linspace(0, 24, 25))
    mb.add_line("y", np.linspace(0, 15, 16))
    mb.add_line("z", np.linspace(0, 19, 20))
    grid = mb.build(1.0)
    assert grid.shape == (25, 16, 20), grid.shape
    scene = Scene()
    scene.add_material_box("sub", 4.3, 0.005, [8, 4, 8], [18, 11, 10], 0)
    scene.add_metal_box("patch", [10, 6, 10], [16, 10, 10], priority=10)
    scene.add_metal_box("gnd", [8, 4, 8], [18, 11, 8], priority=10)
    scene.add_lumped_port(1, 50.0, [13, 8, 8], [13, 8, 10], direction="z")
    cfg = FDTDConfig(n_steps_max=n_steps, check_every=60,
                     end_criteria=1e-30, probe_decimation=4,
                     boundary=boundary)
    return build_simulation(
        scene, grid, f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, 7),
        nf_freqs_hz=np.array([2.45e9]), nf_margin_cells=2,
        pad_multiple=(8, 1, 1),
    )


def test_explicit_mur_face_straddle():
    """When the MUR top x-face sits exactly on a shard boundary, its
    inward neighbor row lives on the previous device: the explicit XLA
    step fetches it through the extra ``straddle_top`` halo and must
    still match the single-device run."""
    from fdtd_solver_antennas_tpu.parallel.explicit import build_explicit_run

    sim = _build_straddle()
    n = sim.padded_shape[0] // 8
    assert (sim.grid.shape[0] - 1) % n == 0, "face not on a shard boundary"
    ref = _build_straddle().run()
    got = build_explicit_run(sim, make_device_mesh((8,), ("x",)))()
    assert int(got["steps"]) == int(ref["steps"])
    _close_explicit(got["uf"], ref["uf"])
    _close_explicit(got["if_"], ref["if_"])
    for fa, fb in zip(got["fields"], ref["fields"]):
        _close_explicit(fa, fb)


def test_explicit_pec_walls():
    """Explicit XLA step with PEC walls (no MUR fix-ups, zero boundary
    coefficients): the halo exchange alone must reproduce the
    single-device run, NF2FF accumulators included."""
    from fdtd_solver_antennas_tpu.parallel.explicit import build_explicit_run

    ref = _build_straddle(n_steps=240, boundary="PEC").run()
    sim = _build_straddle(n_steps=240, boundary="PEC")
    got = build_explicit_run(sim, make_device_mesh((8,), ("x",)))()
    assert int(got["steps"]) == int(ref["steps"])
    _close_explicit(got["uf"], ref["uf"])
    for a, b in zip(got["nf_e"], ref["nf_e"]):
        _close_explicit(a, b)
    for fa, fb in zip(got["fields"], ref["fields"]):
        _close_explicit(fa, fb)


def test_explicit_resume_pml():
    """Resume under CPML on the explicit path: the checkpoint's 12 ψ
    arrays are sharded back onto the devices with the fields, and the
    resumed run must match the uninterrupted sharded run."""
    from fdtd_solver_antennas_tpu.parallel.explicit import build_explicit_run

    mesh = make_device_mesh((8,), ("x",))
    ref = build_explicit_run(_build_pml(pad_x=8, n_steps=400), mesh)()

    out_a = build_explicit_run(_build_pml(pad_x=8, n_steps=100), mesh)()
    assert 100 <= int(out_a["steps"]) < int(ref["steps"])  # chunk-rounded
    assert set(out_a["state"]["psi_e"]) == {"xy", "xz", "yz", "yx", "zx", "zy"}

    out_b = build_explicit_run(_build_pml(pad_x=8, n_steps=400), mesh)(
        resume_state=out_a["state"])
    assert int(out_b["steps"]) == int(ref["steps"])
    _close_explicit(out_b["uf"], ref["uf"])
    for a, b in zip(out_b["nf_e"], ref["nf_e"]):
        _close_explicit(a, b)
    for fa, fb in zip(out_b["fields"], ref["fields"]):
        _close_explicit(fa, fb)


# ---------------------------------------------------------------------------
# HLO collective-count guard
# ---------------------------------------------------------------------------

def _collective_counts(run):
    """(collective-permute sites, all-reduce sites) in the compiled HLO."""
    import re

    txt = run.lowered().compile().as_text()
    return (
        len(re.findall(r"collective-permute", txt)),
        len(re.findall(r"all-reduce", txt)),
    )


def test_hlo_collective_counts_pin_halo_structure():
    """Structural guard on the explicit path's collective schedule: one
    ppermute per half-step (+1 when the top MUR face straddles a shard
    boundary), all inside the once-traced step body, so 2–3 static
    sites. A regression that added exchanges would pass every numeric
    equality test (they don't measure traffic); counting collective ops
    in the compiled module pins it on CPU.

    all-reduce sites are pinned at 7 (1 per-chunk energy psum + 4 final
    DFT psums + 2 jax replication checks): a per-sample psum of the
    DFT accumulators — the regression the 'one final psum' claim guards
    against — would add sites.
    """
    from fdtd_solver_antennas_tpu.parallel.explicit import build_explicit_run

    mesh = make_device_mesh((8,), ("x",))
    sim = _build(pad_x=8)
    Px = sim.padded_shape[0]
    n = Px // 8
    straddle = (sim.grid.shape[0] - 1) % n == 0
    run = build_explicit_run(sim, mesh)
    cp, ar = _collective_counts(run)
    assert cp == 2 + (1 if straddle else 0), (
        f"XLA step path: {cp} collective-permute sites (straddle={straddle})"
    )
    assert ar == 7, f"XLA step path: {ar} all-reduce sites"
