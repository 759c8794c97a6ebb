"""Process-level setup: the compile-cache location, importing the engine
without the optional plotting/validation packages, and the parameter
models' validation."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest

from fdtd_solver_antennas_tpu.models.params import (
    HornAntennaParams,
    MetalProperties,
    PatchAntennaParams,
)
from fdtd_solver_antennas_tpu.utils import backend

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch,
                                                      restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = backend.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert backend.enable_compile_cache() == path  # stable across calls


def test_engine_imports_without_pydantic_or_matplotlib():
    """The engine and its entry points import with neither package
    installed; plotting names resolve lazily (and only then need
    matplotlib)."""
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("pydantic", "matplotlib"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import fdtd_solver_antennas_tpu as pkg
        import fdtd_solver_antennas_tpu.__main__
        import fdtd_solver_antennas_tpu.parallel
        import fdtd_solver_antennas_tpu.solvers.inverse
        import fdtd_solver_antennas_tpu.solvers.sweep
        assert "matplotlib" not in sys.modules
        assert "pydantic" not in sys.modules
        try:
            pkg.plot_3d_pattern
        except ImportError as e:
            assert "matplotlib" in str(e)
        else:
            raise AssertionError("plotting resolved without matplotlib")
        print("OK")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={"JAX_PLATFORMS": "cpu",
                                     "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_plotting_names_resolve_lazily():
    import fdtd_solver_antennas_tpu as pkg
    from fdtd_solver_antennas_tpu.viz import plotting

    assert pkg.plot_cross_sections is plotting.plot_cross_sections
    with pytest.raises(AttributeError):
        pkg.no_such_name


PATCH = dict(frequency_hz=2.45e9, eps_r=4.3, h_m=1.6e-3)
HORN = dict(frequency_hz=10e9, throat_a_m=0.02, throat_b_m=0.01,
            aperture_A_m=0.08, aperture_B_m=0.06, length_m=0.1)


@pytest.mark.parametrize("cls,base,field,bad", [
    (PatchAntennaParams, PATCH, "frequency_hz", 0.0),
    (PatchAntennaParams, PATCH, "eps_r", 1.0),
    (PatchAntennaParams, PATCH, "h_m", -1e-3),
    (PatchAntennaParams, PATCH, "loss_tangent", -0.01),
    (PatchAntennaParams, PATCH, "patch_length_m", 0.0),
    (PatchAntennaParams, PATCH, "patch_width_m", -0.03),
    (HornAntennaParams, HORN, "frequency_hz", -1.0),
    (HornAntennaParams, HORN, "throat_a_m", 0.0),
    (HornAntennaParams, HORN, "throat_b_m", 0.0),
    (HornAntennaParams, HORN, "aperture_A_m", 0.0),
    (HornAntennaParams, HORN, "aperture_B_m", 0.0),
    (HornAntennaParams, HORN, "length_m", 0.0),
    (MetalProperties, dict(name="Cu", conductivity_s_per_m=5.8e7),
     "conductivity_s_per_m", 0.0),
    (MetalProperties, dict(name="Cu", conductivity_s_per_m=5.8e7),
     "thickness_m", 0.0),
])
def test_param_validation(cls, base, field, bad):
    cls(**base)  # the base values are valid
    with pytest.raises(ValueError, match=field):
        cls(**dict(base, **{field: bad}))


def test_param_boundaries_and_copies():
    # ge 0 admits exactly 0; optional dimensions admit None
    p = PatchAntennaParams(**PATCH, loss_tangent=0.0)
    assert p.patch_length_m is None
    q = dataclasses.replace(p, patch_width_m=0.03)
    assert q.patch_width_m == 0.03 and p.patch_width_m is None
    # a replaced copy is validated again
    with pytest.raises(ValueError):
        dataclasses.replace(p, eps_r=0.5)
    # from_user_units gives each instance its own metal record
    a = PatchAntennaParams.from_user_units(frequency_ghz=2.45, er=4.3,
                                           h_mm=1.6, metal="gold")
    b = PatchAntennaParams.from_user_units(frequency_ghz=2.45, er=4.3,
                                           h_mm=1.6, metal="gold",
                                           metal_thickness_um=5.0)
    assert a.metal is not b.metal
    assert a.metal.thickness_m == 2e-6
    assert b.metal.thickness_m == pytest.approx(5e-6)
