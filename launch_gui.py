#!/usr/bin/env python
"""GUI launcher with dependency checks (reference: launch_gui.py:12-141).

Verifies the Python environment (JAX backend, matplotlib, tkinter +
display), prints actionable messages, and starts the desktop GUI. Unlike
the reference there are no DLLs to locate — the FDTD engine is in-repo.
"""

from __future__ import annotations

import importlib
import os
import sys


def check(name: str, how_to_fix: str) -> bool:
    try:
        importlib.import_module(name)
        print(f"  [ok] {name}")
        return True
    except Exception as e:
        print(f"  [MISSING] {name}: {e}\n     → {how_to_fix}")
        return False


def main() -> int:
    print("Checking environment…")
    ok = True
    ok &= check("numpy", "pip install numpy")
    ok &= check("jax", "pip install jax (CPU) or jax[cuda12] (GPU)")
    ok &= check("matplotlib", "pip install matplotlib")
    if not ok:
        print("Install the missing dependencies and retry.")
        return 1

    import jax

    print(f"  [ok] jax backend: {jax.devices()}")

    try:
        import tkinter  # noqa: F401
    except Exception:
        print(
            "  [MISSING] tkinter — install your OS's python3-tk package.\n"
            "Falling back: use the CLI (python -m fdtd_solver_antennas_tpu)\n"
            "or the web UI (streamlit run "
            "fdtd_solver_antennas_tpu/frontends/webapp.py)."
        )
        return 1
    if not os.environ.get("DISPLAY") and sys.platform.startswith("linux"):
        print(
            "  [WARN] no DISPLAY — the desktop GUI needs a display/X server.\n"
            "Use the CLI or the web UI on headless machines."
        )
        return 1

    print("Starting GUI…")
    from fdtd_solver_antennas_tpu.frontends.gui_app import main as gui_main

    gui_main()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
