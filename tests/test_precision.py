"""Every float32 product that feeds a reported number runs at HIGHEST
precision: on a GPU a default-precision matmul may run in TF32 (~3
decimal digits), which would land directly in the port spectra, S11 and
the far-field pattern. Each test lowers one product site and requires
every ``dot_general`` in it to carry HIGHEST."""

import re

import jax
import jax.numpy as jnp
import numpy as np

from fdtd_solver_antennas_tpu.ops.fdtd import FDTDConfig, build_simulation
from fdtd_solver_antennas_tpu.parallel.sharding import make_device_mesh
from test_xla_step import _patch_grid, _patch_scene


def _assert_all_dots_highest(lowered):
    dots = re.findall(r"stablehlo\.dot_general[^\n]*", lowered.as_text())
    assert dots, "no dot_general in the lowered program"
    for d in dots:
        assert "precision = [HIGHEST, HIGHEST]" in d, d


def _sim(pad_x=1):
    cfg = FDTDConfig(n_steps_max=100, check_every=100, end_criteria=1e-30,
                     probe_decimation=4)
    return build_simulation(
        _patch_scene(), _patch_grid(), f0=2.45e9, fc=1.225e9, cfg=cfg,
        port_freqs_hz=np.linspace(2e9, 3e9, 7),
        nf_freqs_hz=np.array([2.45e9]), pad_multiple=(pad_x, 1, 1),
    )


def test_engine_dft_flush_is_highest():
    """ops/fdtd.py: the chunked port and Huygens-face DFT flush."""
    _assert_all_dots_highest(_sim().lower_superchunk())


def test_explicit_path_dft_flush_is_highest():
    """parallel/explicit.py: the per-device partial DFT flush."""
    from fdtd_solver_antennas_tpu.parallel.explicit import build_explicit_run

    run = build_explicit_run(_sim(pad_x=4),
                             make_device_mesh((4,), ("x",),
                                              devices=jax.devices()[:4]))
    _assert_all_dots_highest(run.lowered())


def test_nf2ff_radiation_integrals_are_highest():
    """post/nf2ff.py: the surface-equivalence radiation integrals."""
    from fdtd_solver_antennas_tpu.post.nf2ff import _radiation_integrals

    P, K, A = 16, 2, 5
    f = jnp.ones((K, P, 3), jnp.float32)
    _assert_all_dots_highest(_radiation_integrals.lower(
        jnp.ones((P, 3)), jnp.ones((P,)), f, f, f, f, jnp.ones((K,)),
        jnp.ones((A, 3)),
    ))


def test_adjoint_far_field_is_highest():
    """solvers/inverse.py: the traced NF2FF twin of the broadside-gain
    objective (its step loop accumulates elementwise)."""
    from fdtd_solver_antennas_tpu.models.params import PatchAntennaParams
    from fdtd_solver_antennas_tpu.solvers.inverse import prepare_patch_inverse

    problem = prepare_patch_inverse(
        PatchAntennaParams.from_user_units(
            frequency_ghz=2.45, er=4.3, h_mm=1.6, loss_tangent=0.02),
        mesh_divisor=8.0, fc_hz=2.45e9, box_mm=(80.0, 80.0, 40.0),
        sub_mm=50.0, substrate_cells=2, n_steps=800,
    )
    rho = jnp.full(problem.region.shape, 0.5, jnp.float32)
    _assert_all_dots_highest(
        jax.jit(problem.broadside_gain_loss).lower(rho))
