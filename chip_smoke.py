#!/usr/bin/env python3
"""Smoke run of the FDTD engine on an NVIDIA GPU.

    python chip_smoke.py               # phases 1-8 on one GPU
    python chip_smoke.py --four-cards  # only the four-GPU paths (phase 9)

Drives the main path through the entry points a user calls, at the sizes
users run, and checks every result by the repository's own means: the
NumPy reference stepper (tests/_numpy_reference.py), the openEMS tutorial
bands (tests/test_golden_openems.py) and the CLI's sanity bands. Every
time it prints is one smoke run on the named card, not a benchmark
result.

It refuses to run (non-zero exit, no result line) when JAX finds no GPU
or when it is not inside a checkout of the repository. All phases run in
this one process, the only one that opens the cards. A failed phase is
reported and the others still run; any failure makes the exit code
non-zero and suppresses the result line. The last line of standard output
on success is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
TESTS = REPO / "tests"

# the openEMS-anchor and reference-step scenes are the canonical 2.45 GHz
# FR-4 patch: εr 4.3, h 1.6 mm, tan δ 0.02
CANONICAL = dict(frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02)
REF_STEPS = 300
REF_TOL = 1e-4  # max|Δ| ≤ REF_TOL · max|ref| for every field component
DMAX_BAND_DBI = (5.0, 8.0)  # CLI sanity band (canonical patch)
S11_MAX_DB = -8.0
FOUR_CARD_TOL = 1e-4  # port V/I DFT max relative error vs one card


class SmokeFailure(Exception):
    """A check of the smoke run failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require_repo() -> None:
    """Exit non-zero unless this file sits in a checkout of the repo."""
    need = (REPO / "fdtd_solver_antennas_tpu" / "__init__.py",
            TESTS / "_numpy_reference.py")
    missing = [str(p) for p in need if not p.is_file()]
    if missing:
        print(f"chip_smoke: not inside the repository (missing {missing})",
              file=sys.stderr)
        sys.exit(2)
    for p in (str(REPO), str(TESTS)):
        if p not in sys.path:
            sys.path.insert(0, p)


def require_gpu(devices) -> None:
    """Exit non-zero unless JAX's default devices are GPUs."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (default platform {platform!r})",
              file=sys.stderr)
        sys.exit(3)


def nvidia_smi() -> list:
    """Card name and power limit per GPU, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def canonical_params():
    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams

    return PatchAntennaParams.from_user_units(**CANONICAL)


def cap_steps(sim, n_steps_max: int) -> None:
    """Lower a prepared simulation's step budget (rebuilds its run fn)."""
    import dataclasses

    from fdtd_solver_antennas_tpu.ops.fdtd import rebuild_run_fn

    sim.cfg = dataclasses.replace(sim.cfg, n_steps_max=int(n_steps_max))
    rebuild_run_fn(sim)


def gcells(sim, steps: int, seconds: float, n_batch: int = 1) -> float:
    return sim.grid.num_cells * steps * n_batch / seconds / 1e9


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(cache_dir: str) -> dict:
    import jax

    devs = jax.devices()
    log("1 device", f"device_kind={devs[0].device_kind!r} "
        f"count={len(devs)} platform={devs[0].platform}")
    cards = nvidia_smi()
    log("1 device", "nvidia-smi --query-gpu=name,power.limit "
        "--format=csv,noheader:")
    for line in cards:  # verbatim, one card per line
        print(line, flush=True)
    log("1 device", f"compile cache: {cache_dir}")
    check(len(cards) >= 1, "nvidia-smi listed no card")
    return {"cards": cards}


def check_step_against_reference(sim) -> tuple:
    """Run ``sim`` through its normal run path and the same number of
    steps through the NumPy reference; returns (steps, {field: ratio})
    with ratio = max|Δ| / max|ref|."""
    import numpy as np

    from _numpy_reference import run_reference

    out = sim.run()
    steps = int(out["steps"])
    E, H = run_reference(sim, steps)
    ref = (E["x"], E["y"], E["z"], H["x"], H["y"], H["z"])
    ratios = {}
    for name, got, want in zip(("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"),
                               out["fields"], ref):
        got = np.asarray(got)
        check(np.isfinite(got).all(), f"{name}: non-finite values")
        ratios[name] = float(np.abs(got - want).max()
                             / max(float(np.abs(want).max()), 1e-30))
    return steps, ratios


def phase_reference_step(n_steps: int = REF_STEPS) -> dict:
    from fdtd_solver_antennas_tpu.solvers.patch_fixed import (
        prepare_patch_fixed,
    )

    t0 = time.perf_counter()
    prep = prepare_patch_fixed(canonical_params(), n_steps_max=n_steps)
    check(prep.ok, prep.message)
    log("2 reference", f"canonical patch grid {prep.sim.grid.shape} = "
        f"{prep.sim.grid.num_cells} cells, prepare "
        f"{time.perf_counter() - t0:.3f} s")
    steps, ratios = check_step_against_reference(prep.sim)
    worst = max(ratios.values())
    log("2 reference", f"{steps} steps (requested {n_steps}; the engine "
        "runs whole termination chunks) vs NumPy reference: max|Δ|/max|ref| "
        + ", ".join(f"{k}={v:.3e}" for k, v in ratios.items()))
    check(worst <= REF_TOL, f"step deviates from the reference: {worst:.3e}"
          f" > {REF_TOL:g}")
    return {"steps": steps, "worst_ratio": worst}


def phase_openems_anchor() -> dict:
    import numpy as np

    from fdtd_solver_antennas_tpu.solvers.patch_fixed import (
        prepare_patch_fixed,
        run_prepared_fixed,
    )
    from test_golden_openems import (
        GOLDEN_DMAX_DBI,
        GOLDEN_F_RES_HZ,
        GOLDEN_F_TOL,
        GOLDEN_S11_MAX_DB,
        TUT_F0_HZ,
        _tutorial_params,
    )

    t0 = time.perf_counter()
    prep = prepare_patch_fixed(_tutorial_params(), verbose=0)
    t_prep = time.perf_counter() - t0
    check(prep.ok, prep.message)
    sim = prep.sim
    first = run_prepared_fixed(prep, frequency_hz=TUT_F0_HZ, verbose=0)
    check(first.ok, first.message)
    res = run_prepared_fixed(prep, frequency_hz=TUT_F0_HZ, verbose=0)
    check(res.ok, res.message)
    steps, run_s = int(res.steps_run), float(res.wall_time_s)
    log("3 openEMS", f"tutorial grid {sim.grid.shape} = "
        f"{sim.grid.num_cells} cells; single smoke run: prepare "
        f"{t_prep:.3f} s, compile ≈ {first.wall_time_s - run_s:.3f} s "
        f"(first run {first.wall_time_s:.3f} s minus second), run "
        f"{run_s:.3f} s, {steps} steps, "
        f"{gcells(sim, steps, run_s):.3f} Gcell-updates/s")

    f_res = float(res.f_res_hz)
    s11_min = float(20 * np.log10(np.abs(res.s11) + 1e-30).min())
    dmax = float(10 * np.log10(res.Dmax))
    i_res = int(np.argmin(np.abs(res.freq - f_res)))
    re_z = float(abs(res.z_in[i_res].real))
    log("3 openEMS", f"f_res {f_res / 1e9:.4f} GHz (published 2.40), "
        f"S11 min {s11_min:.2f} dB, Dmax {dmax:.2f} dBi, "
        f"Re Zin {re_z:.1f} Ω")
    rel = abs(f_res - GOLDEN_F_RES_HZ) / GOLDEN_F_RES_HZ
    check(rel < GOLDEN_F_TOL, f"f_res off by {rel * 100:.2f}%")
    check(s11_min <= GOLDEN_S11_MAX_DB, f"S11 dip {s11_min:.2f} dB too shallow")
    check(GOLDEN_DMAX_DBI[0] < dmax < GOLDEN_DMAX_DBI[1],
          f"directivity {dmax:.2f} dBi outside {GOLDEN_DMAX_DBI}")
    check(25.0 < re_z < 100.0, f"Re Zin {re_z:.1f} Ω outside (25, 100)")
    return {"steps": steps, "run_s": run_s}


def run_cli_s11(outdir: Path, steps_max: int = 30_000) -> dict:
    """Call the CLI's ``main`` in this process (no second JAX process)
    with the canonical ``s11`` arguments; returns its JSON summary."""
    from fdtd_solver_antennas_tpu.__main__ import main

    argv = ["s11", "--frequency-ghz", "2.45", "--er", "4.3", "--h-mm",
            "1.6", "--loss-tangent", "0.02", "--solver", "fixed",
            "--outdir", str(outdir), "--steps-max", str(steps_max)]
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def check_cli_summary(summary: dict, steps_max: int) -> None:
    lo, hi = DMAX_BAND_DBI
    check(summary["s11_min_db"] < S11_MAX_DB,
          f"S11 min {summary['s11_min_db']:.2f} dB not below {S11_MAX_DB}")
    check(summary["Dmax_dbi"] is not None
          and lo <= summary["Dmax_dbi"] <= hi,
          f"Dmax {summary['Dmax_dbi']} dBi outside {DMAX_BAND_DBI}")
    check(summary["steps"] < steps_max,
          f"ran to the step cap ({summary['steps']} steps): the end "
          "criterion was never met")


def phase_cli() -> dict:
    steps_max = 30_000
    summary = run_cli_s11(REPO / "outputs" / "chip_smoke_cli", steps_max)
    log("4 CLI", "s11 summary: " + json.dumps(summary))
    check_cli_summary(summary, steps_max)
    return summary


def phase_pml() -> dict:
    import numpy as np

    from fdtd_solver_antennas_tpu.solvers.patch_fixed import (
        prepare_patch_fixed,
        run_prepared_fixed,
    )

    prep = prepare_patch_fixed(canonical_params(), boundary="PML_8")
    check(prep.ok, prep.message)
    res = run_prepared_fixed(prep, frequency_hz=2.45e9, verbose=0)
    check(res.ok, res.message)
    s11_min = float(20 * np.log10(np.abs(res.s11) + 1e-30).min())
    summary = {"s11_min_db": s11_min,
               "Dmax_dbi": float(10 * np.log10(res.Dmax)),
               "steps": int(res.steps_run)}
    log("5 PML_8", f"grid {prep.sim.grid.shape}; single smoke run (compile "
        f"included): {res.wall_time_s:.3f} s, " + json.dumps(summary))
    # z_in = U/I of the port V/I DFTs: finite only if both are
    check(np.isfinite(res.z_in).all(), "non-finite port DFTs")
    check_cli_summary(summary, prep.sim.cfg.n_steps_max)
    return summary


def mixed_scene():
    """The 4.2M-cell patch + horn scene (examples/mixed_patch_horn.py)."""
    from fdtd_solver_antennas_tpu import HornAntennaParams
    from fdtd_solver_antennas_tpu.frontends.designer import MultiPatchScene

    scene = MultiPatchScene()
    scene.add_patch(canonical_params())
    scene.add_horn(
        HornAntennaParams.from_user_units(
            frequency_ghz=2.45, throat_a_mm=86.0, throat_b_mm=43.0,
            aperture_A_mm=150.0, aperture_B_mm=110.0, length_mm=60.0,
        ),
        center_x_m=0.18, rot_z_deg=25.0,
    )
    scene.controls.mesh_quality = 2
    return scene


def prepare_mixed(pad_multiple=(1, 1, 1)):
    import jax

    t0 = time.perf_counter()
    prep = mixed_scene().prepare(pad_multiple=pad_multiple)
    check(prep.ok, prep.message)
    jax.block_until_ready(prep.sim.coeffs["cb_ez"])
    return prep.sim, time.perf_counter() - t0


def phase_large_scene(step_cap: int) -> dict:
    import numpy as np

    sim, t_prep = prepare_mixed()
    log("6 large", f"grid {sim.grid.shape} = {sim.grid.num_cells} cells, "
        f"prepare {t_prep:.3f} s (voxelize + coefficients + upload)")
    capped = step_cap < sim.cfg.n_steps_max
    if capped:
        log("6 large", f"step cap {step_cap} (scene budget "
            f"{sim.cfg.n_steps_max})")
        cap_steps(sim, step_cap)
    t0 = time.perf_counter()
    mem = sim.lower_superchunk().compile().memory_analysis()
    log("6 large", f"superchunk compile {time.perf_counter() - t0:.3f} s; "
        f"memory_analysis: {mem}")
    t0 = time.perf_counter()
    out = sim.run()
    wall = time.perf_counter() - t0
    steps = int(out["steps"])
    e_ratio = float(out["e_ratio"])
    log("6 large", f"single smoke run: {wall:.3f} s for {steps} steps, "
        f"{gcells(sim, steps, wall):.3f} Gcell-updates/s, energy ratio "
        f"{e_ratio:.3e} (end criterion {sim.cfg.end_criteria:.3e})")
    check(np.isfinite(np.asarray(out["uf"])).all(), "non-finite port DFTs")
    if steps < sim.cfg.n_steps_max:
        check(e_ratio < sim.cfg.end_criteria,
              "stopped before the cap without meeting the end criterion")
    else:
        log("6 large", "the step cap stopped the run before the end "
            "criterion; energy decay not checked")
    return {"steps": steps, "wall_s": wall}


def sweep_variants(n_var: int = 8):
    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams

    return [
        PatchAntennaParams.from_user_units(
            **CANONICAL, W_mm=37.26 + 0.5 * i, L_mm=28.83 + 0.4 * i,
        )
        for i in range(n_var)
    ]


def prepare_sweep(variants, n_steps: int):
    from fdtd_solver_antennas_tpu.solvers.sweep import (
        prepare_patch_geometry_sweep,
    )

    prep = prepare_patch_geometry_sweep(variants, n_steps_max=n_steps,
                                        end_criteria=1e-4)
    check(prep.ok, prep.message)
    return prep


def check_distinct_spectra(uf) -> None:
    """Every variant's port spectrum must differ from every other's (the
    guard against one geometry broadcast over the batch)."""
    import numpy as np

    for i in range(len(uf)):
        for j in range(i + 1, len(uf)):
            check(not np.allclose(uf[i], uf[j], rtol=1e-3),
                  f"variants {i} and {j} have the same spectrum")


def phase_sweep(variants=None, n_steps: int = 2000) -> dict:
    import numpy as np

    from fdtd_solver_antennas_tpu.solvers.sweep import _run_batched

    variants = variants if variants is not None else sweep_variants()
    prep = prepare_sweep(variants, n_steps)
    _, first, _ = _run_batched(prep)
    out, wall, steps = _run_batched(prep)
    uf = np.asarray(out["uf"])
    log("7 sweep", f"{len(variants)} variants on union grid "
        f"{prep.sim.grid.shape}; single smoke run: first {first:.3f} s "
        f"(compile included), second {wall:.3f} s for {steps} steps, "
        f"{gcells(prep.sim, steps, wall, len(variants)):.3f} "
        "Gcell-updates/s aggregate")
    check(np.isfinite(uf).all(), "non-finite spectra")
    check_distinct_spectra(uf)
    return {"steps": steps, "wall_s": wall}


def phase_adjoint(problem=None, n_iters: int = 2) -> dict:
    import jax
    import numpy as np

    from fdtd_solver_antennas_tpu.solvers.inverse import prepare_patch_inverse

    t0 = time.perf_counter()
    if problem is None:
        problem = prepare_patch_inverse(canonical_params())
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = problem.optimize(n_iters=n_iters)
    wall = time.perf_counter() - t0
    loss = np.asarray(res.history)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log("8 adjoint", f"grid {problem.sim.grid.shape}, {problem.n_steps} "
        f"steps per forward; prepare {t_prep:.3f} s, {n_iters} iterations "
        f"in {wall:.3f} s (compile included); loss {loss.tolist()}; peak "
        "device memory "
        + (f"{peak / 2**30:.3f} GiB" if peak is not None else "not reported"))
    check(np.isfinite(loss).all(), "non-finite loss")
    # Adam turns a non-finite gradient into non-finite logits, and a zero
    # gradient leaves the density at its 0.5 start
    check(np.isfinite(res.rho).all(), "non-finite gradient")
    check(not np.allclose(res.rho, 0.5), "zero gradient")
    return {"loss": loss.tolist(), "peak_bytes": peak}


PHASES = (
    ("2 reference", phase_reference_step),
    ("3 openEMS", phase_openems_anchor),
    ("4 CLI", phase_cli),
    ("5 PML_8", phase_pml),
    ("6 large", lambda: phase_large_scene(step_cap=60_000)),
    ("7 sweep", phase_sweep),
    ("8 adjoint", phase_adjoint),
)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def max_rel_err(got, ref) -> float:
    import numpy as np

    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(float(np.abs(ref).max()),
                                               1e-30))


def run_four_card_paths(make_sim, variants, step_cap: int,
                        sweep_steps: int) -> dict:
    """GSPMD, explicit shard_map and sweep×spatial runs over four devices,
    each against the same run on one device of this process."""
    import jax

    from fdtd_solver_antennas_tpu.parallel import (
        build_explicit_run,
        make_device_mesh,
        make_sweep_mesh,
        shard_simulation,
        shard_sweep,
    )
    from fdtd_solver_antennas_tpu.solvers.sweep import run_patch_geometry_sweep

    check(len(jax.devices()) >= 4, f"need 4 devices, have {jax.devices()}")
    devices = jax.devices()[:4]
    errs = {}

    sim = make_sim((4, 1, 1))
    cap_steps(sim, step_cap)
    log("9 four", f"grid {sim.grid.shape} padded {sim.padded_shape}, "
        f"step cap {step_cap}")

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out["steps"])
        return out, time.perf_counter() - t0

    ref, t_ref = timed(sim.run)
    steps = int(ref["steps"])
    mesh = make_device_mesh((4,), ("x",), devices=devices)
    runs = {}
    runs["explicit"] = timed(build_explicit_run(sim, mesh))
    shard_simulation(sim, mesh)  # in place: coefficients resharded
    runs["gspmd"] = timed(sim.run)
    log("9 four", f"one card: {t_ref:.3f} s for {steps} steps "
        "(compile included, single smoke run)")
    for name, (out, t) in runs.items():
        check(int(out["steps"]) == steps, f"{name}: {out['steps']} steps "
              f"!= {steps}")
        errs[name] = max(max_rel_err(out["uf"], ref["uf"]),
                         max_rel_err(out["if_"], ref["if_"]))
        log("9 four", f"{name} on 4 cards: {t:.3f} s (compile included), "
            f"port V/I DFT max rel err {errs[name]:.3e}")

    prep = prepare_sweep(variants, sweep_steps)
    ref_s = run_patch_geometry_sweep(prep)
    check(ref_s.ok, ref_s.message)
    shard_sweep(prep, make_sweep_mesh(2, 2, devices=devices))
    got_s = run_patch_geometry_sweep(prep)
    check(got_s.ok, got_s.message)
    errs["sweep×spatial"] = max(
        max(max_rel_err(g.uf, r.uf), max_rel_err(g.if_, r.if_))
        for g, r in zip(got_s.spectra, ref_s.spectra)
    )
    log("9 four", f"sweep×spatial (2, 2) mesh, {len(variants)} variants: "
        f"one card {ref_s.wall_time_s:.3f} s, 4 cards "
        f"{got_s.wall_time_s:.3f} s (compile included), port V/I DFT max "
        f"rel err {errs['sweep×spatial']:.3e}")
    for name, err in errs.items():
        check(err < FOUR_CARD_TOL, f"{name}: rel err {err:.3e} ≥ "
              f"{FOUR_CARD_TOL:g}")
    return errs


def phase_four_cards() -> dict:
    return run_four_card_paths(
        lambda pad: prepare_mixed(pad)[0], sweep_variants(),
        step_cap=4000, sweep_steps=2000,
    )


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU paths (phase 9)")
    args = ap.parse_args(argv)

    require_repo()
    import jax

    devices = jax.devices()
    require_gpu(devices)

    from fdtd_solver_antennas_tpu.utils.backend import enable_compile_cache

    cache_dir = enable_compile_cache()
    phases = (("9 four", phase_four_cards),) if args.four_cards else PHASES
    failed = []
    for name, fn in (("1 device", lambda: phase_device(cache_dir)),) + phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(name, f"ok ({time.perf_counter() - t0:.1f} s)")
        except Exception as e:  # report, keep going, fail at the end
            traceback.print_exc()
            log(name, f"FAILED: {type(e).__name__}: {e}")
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
