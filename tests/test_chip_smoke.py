"""chip_smoke.py: its refusals, its checks, and its phases at tiny size on
the CPU (the full-size phases run only on the GPU)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke as cs
from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
from test_xla_step import _patch_grid, _patch_scene

REPO = Path(__file__).resolve().parents[1]


def _tiny_sim(pad_multiple=(1, 1, 1), n_steps=200):
    cfg = FDTDConfig(n_steps_max=n_steps, check_every=100,
                     end_criteria=1e-30, probe_decimation=4)
    return build_simulation(
        _patch_scene(), _patch_grid(), f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, 7),
        nf_freqs_hz=np.array([2.45e9]), pad_multiple=pad_multiple,
    )


def _run_script(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_require_gpu_refuses_cpu_device():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        cs.require_gpu(jax.devices())
    assert exc.value.code not in (0, None)


def test_script_refuses_without_gpu():
    """On a machine where JAX finds no GPU the script exits non-zero and
    prints no result line."""
    proc = _run_script(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_script_refuses_outside_repo(tmp_path):
    """Alone in a directory (no package, no reference stepper) the script
    exits non-zero before touching JAX."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_script(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "not inside the repository" in proc.stderr


def test_reference_check_passes_on_tiny_scene():
    steps, ratios = cs.check_step_against_reference(_tiny_sim())
    assert steps == 200
    assert set(ratios) == {"Ex", "Ey", "Ez", "Hx", "Hy", "Hz"}
    assert max(ratios.values()) <= cs.REF_TOL


def test_reference_check_catches_a_wrong_step():
    """A corrupted coefficient (what a broken step would look like to the
    reference) must push the ratio far past the tolerance."""
    sim = _tiny_sim()
    sim.coeffs = dict(sim.coeffs, cb_ez=sim.coeffs["cb_ez"] * 1.01)
    ref_sim = _tiny_sim()
    # the reference reads the UNcorrupted coefficients of ref_sim while
    # the engine steps the corrupted ones
    out = sim.run()
    from _numpy_reference import run_reference

    E, _ = run_reference(ref_sim, int(out["steps"]))
    got = np.asarray(out["fields"][2])
    ratio = np.abs(got - E["z"]).max() / np.abs(E["z"]).max()
    assert ratio > cs.REF_TOL


GOOD = {"s11_min_db": -20.0, "Dmax_dbi": 6.5, "steps": 11_000}


@pytest.mark.parametrize("bad", [
    {"s11_min_db": -5.0},
    {"Dmax_dbi": 9.5},
    {"Dmax_dbi": None},
    {"steps": 30_000},
])
def test_cli_summary_bands_reject(bad):
    cs.check_cli_summary(GOOD, 30_000)
    with pytest.raises(cs.SmokeFailure):
        cs.check_cli_summary(dict(GOOD, **bad), 30_000)


def test_cli_runs_in_process(tmp_path):
    """The CLI phase calls ``main`` in this process and gets its JSON
    summary back (a short run: the bands are checked on the card)."""
    summary = cs.run_cli_s11(tmp_path, steps_max=100)
    assert set(summary) >= {"f_res_ghz", "s11_min_db", "Dmax_dbi", "steps"}
    assert np.isfinite(summary["s11_min_db"])
    assert (tmp_path / "s11.npz").is_file()


def test_sweep_phase_tiny():
    res = cs.phase_sweep(cs.sweep_variants(2), n_steps=100)
    assert res["steps"] >= 100


def test_distinct_spectra_guard():
    uf = np.arange(12, dtype=np.float32).reshape(3, 4) + 1.0
    cs.check_distinct_spectra(uf)
    with pytest.raises(cs.SmokeFailure):
        cs.check_distinct_spectra(np.stack([uf[0], uf[1], uf[0]]))


def test_adjoint_phase_tiny():
    from fdtd_solver_antennas_tpu.solvers.inverse import prepare_patch_inverse

    problem = prepare_patch_inverse(
        cs.canonical_params(), mesh_divisor=8.0, fc_hz=2.45e9,
        box_mm=(80.0, 80.0, 40.0), sub_mm=50.0, substrate_cells=2,
        n_steps_max_validate=4000,
    )
    res = cs.phase_adjoint(problem, n_iters=1)
    assert len(res["loss"]) == 1 and np.isfinite(res["loss"][0])


def test_four_card_paths_on_virtual_devices():
    """The --four-cards phase on four virtual CPU devices: GSPMD,
    explicit shard_map and sweep×spatial runs all match one device."""
    errs = cs.run_four_card_paths(
        lambda pad: _tiny_sim(pad), cs.sweep_variants(2),
        step_cap=200, sweep_steps=100,
    )
    assert set(errs) == {"explicit", "gspmd", "sweep×spatial"}
    assert max(errs.values()) < cs.FOUR_CARD_TOL


def test_lower_superchunk_reports_memory():
    mem = _tiny_sim().lower_superchunk().compile().memory_analysis()
    assert mem.argument_size_in_bytes > 0


@pytest.mark.gpu
def test_reference_step_on_gpu(gpu):
    """Phase 2 at its real size: the canonical patch on the card against
    the NumPy reference."""
    res = cs.phase_reference_step()
    assert res["worst_ratio"] <= cs.REF_TOL
