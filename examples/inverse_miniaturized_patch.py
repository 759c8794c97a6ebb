"""Headline inverse-design result: a miniaturized 2.45 GHz patch.

The closed-form Hammerstad–Jensen design for 2.45 GHz on FR-4
(εr 4.3, h 1.6 mm — `physics.py::design_patch_for_frequency`, reference
contract `antenna_sim/physics.py:41-48`) needs a 28.8 × 37.2 mm patch.
This script squeezes the radiator into a design region only ~72% of
that linear size (**~52% of the footprint area**) — where a solid patch
of the full region resonates far ABOVE the target and no classical
rectangular design exists — and lets the adjoint optimizer
(`solvers/inverse.py`, reverse-mode AD through the FDTD loop) carve a
slotted metallization that brings the resonance down to 2.45 GHz.

Workflow (the one the module docstring prescribes):
1. baseline: solid metal over the whole (shrunken) region, validated
   through the standard energy-terminated engine → resonance sits high;
2. optimize: Adam on the density logits against mean |S11|² in a narrow
   band around 2.45 GHz (fixed-step differentiable forward);
3. threshold at 0.5 and VALIDATE the binary design through the standard
   engine path — every number reported below comes from that run, never
   from the soft density model.

On the GPU the run time is not measured yet; on CPU use --quick.

Usage:
    python examples/inverse_miniaturized_patch.py [--iters 60] [--quick]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--shrink", type=float, default=0.72,
                    help="design-region linear size vs the closed-form "
                         "patch (0.72 → 52%% of the footprint area)")
    ap.add_argument("--outdir", type=str, default="outputs")
    ap.add_argument("--quick", action="store_true",
                    help="small CPU-friendly configuration (coarser mesh, "
                         "fewer iterations) — demonstrates the mechanics, "
                         "not the headline numbers")
    args = ap.parse_args()

    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu.physics import design_patch_for_frequency
    from fdtd_solver_antennas_tpu.solvers.inverse import prepare_patch_inverse
    from fdtd_solver_antennas_tpu.utils.backend import enable_compile_cache

    enable_compile_cache()

    f0 = 2.45e9
    params = PatchAntennaParams.from_user_units(
        frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02
    )
    L_m, W_m, _ = design_patch_for_frequency(f0, 4.3, 1.6e-3)
    s = float(args.shrink)
    # region centered like the canonical patch, shrunk per side
    region = (
        -W_m / 2 * 1e3 * s, W_m / 2 * 1e3 * s,
        -L_m / 2 * 1e3 * s, L_m / 2 * 1e3 * s,
    )
    print(
        f"closed-form patch: {W_m * 1e3:.1f} × {L_m * 1e3:.1f} mm; "
        f"design region: {(region[1] - region[0]):.1f} × "
        f"{(region[3] - region[2]):.1f} mm "
        f"({100 * s * s:.0f}% of the footprint area)"
    )

    mesh_divisor = 12.0 if args.quick else 18.0
    n_iters = 8 if args.quick else int(args.iters)
    prob = prepare_patch_inverse(
        params,
        region_mm=region,
        freqs_hz=np.linspace(0.96 * f0, 1.04 * f0, 5),
        mesh_divisor=mesh_divisor,
        fc_hz=f0,  # wide band halves the source → cheaper iterations
        n_steps_max_validate=12_000,
    )
    print(f"grid {prob.sim.grid.shape}, design pixels {prob.region.shape}, "
          f"{prob.n_steps} differentiable steps/iter")

    # -- baseline: solid metal over the whole shrunken region -------------
    solid = np.ones(prob.region.shape, np.float32)
    base = prob.validate(solid)
    f_base = base["f_res_hz"]
    print(
        f"baseline (solid {100 * s * s:.0f}%-area patch): resonance "
        f"{f_base / 1e9:.3f} GHz, S11 {base['s11_db']:.1f} dB "
        f"(target {f0 / 1e9:.2f} GHz missed by "
        f"{100 * abs(f_base - f0) / f0:.1f}%)"
    )

    # -- adjoint optimization ---------------------------------------------
    t0 = time.perf_counter()
    res = prob.optimize(n_iters=n_iters, lr=0.08, beta_sharpen=4.0)
    print(
        f"optimized {n_iters} iterations in {time.perf_counter() - t0:.0f}s; "
        f"loss {res.history[0]:.4f} → {res.history[-1]:.4f}"
    )

    # -- validate the binarized design through the standard engine --------
    val = prob.validate(res.rho)
    f_opt = val["f_res_hz"]
    fill = float((np.asarray(res.rho) >= 0.5).mean())
    print(
        f"validated optimized design: resonance {f_opt / 1e9:.3f} GHz "
        f"(target miss {100 * abs(f_opt - f0) / f0:.2f}%), "
        f"S11 {val['s11_db']:.1f} dB, metal fill {100 * fill:.0f}%"
    )

    # -- figure -------------------------------------------------------------
    import pathlib

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(11, 4.2))
    ax0.imshow(
        (np.asarray(res.rho) >= 0.5).T, origin="lower", cmap="copper",
        extent=[region[0], region[1], region[2], region[3]], aspect="equal",
    )
    ax0.set_title(
        f"optimized metallization ({(region[1] - region[0]):.0f}×"
        f"{(region[3] - region[2]):.0f} mm region, "
        f"{100 * s * s:.0f}% of closed-form area)"
    )
    ax0.set_xlabel("x (mm)")
    ax0.set_ylabel("y (mm)")

    for tag, out, style in (("solid baseline", base, "--"),
                            ("optimized", val, "-")):
        sp = out["spectra"]
        db = 20 * np.log10(np.abs(sp.s11) + 1e-12)
        ax1.plot(sp.freq_hz / 1e9, db, style, label=tag)
    ax1.axvline(f0 / 1e9, color="k", lw=0.8, alpha=0.6)
    ax1.set_xlabel("frequency (GHz)")
    ax1.set_ylabel("S11 (dB)")
    ax1.set_title("validated through the standard engine")
    ax1.legend()
    ax1.grid(alpha=0.3)
    fig.tight_layout()
    path = outdir / "inverse_miniaturized_patch.png"
    fig.savefig(path, dpi=160)
    print(f"Saved: {path}")

    # headline check: the optimizer must have pulled the resonance to
    # within 2% of target from a baseline that misses by >10%
    if not args.quick:
        assert abs(f_base - f0) / f0 > 0.10, "baseline unexpectedly on target"
        assert abs(f_opt - f0) / f0 < 0.02, (
            f"optimized design missed: {f_opt / 1e9:.3f} GHz")
        print("HEADLINE OK: >10% baseline miss pulled to <2% of target")


if __name__ == "__main__":
    main()
