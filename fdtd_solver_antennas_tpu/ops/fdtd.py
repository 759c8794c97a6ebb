"""Yee-grid FDTD engine in JAX/XLA.

This module replaces the openEMS C++ time stepper the reference drives via
``FDTD.Run`` (``solver_fdtd_openems_fixed.py:171,280``):

- staggered (Ex..Hz) leapfrog update on a graded mesh, expressed as fused
  elementwise XLA ops with per-axis inverse-spacing vectors (the non-uniform
  mesh costs nothing inside the loop);
- first-order MUR absorbing walls (the reference's default,
  ``fixed.py:173``) or PEC walls;
- lumped resistive port folded into the E-update as an equivalent edge
  conductivity + soft current source (``AddLumpedPort`` analog), with V/I
  probes and in-loop DFT accumulation → S11 without any disk I/O (the
  reference engine writes field dumps and re-reads them, ``fixed.py:222-227``);
- Huygens-box surface DFT accumulation for NF2FF (replaces
  ``CreateNF2FFBox``/``CalcNF2FF`` file round-trip);
- ``EndCriteria``-style energy-decay early exit via a chunked
  ``lax.while_loop`` (data-dependent exit with static shapes).

Everything is compiled once per grid shape; geometry changes only swap
coefficient arrays, which makes ``vmap`` geometry sweeps one program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..physics import C0, EPS0, MU0
from ..models.scene import LumpedPortSpec, Scene
from .mesh import YeeGrid
from .source import source_active_steps
from .voxelize import cell_to_edge_average, voxelize

_AXIS_OF = {"x": 0, "y": 1, "z": 2}

# CPML auxiliary-field keys: ψ_<field comp><derivative axis>
PSI_KEYS = ("xy", "xz", "yz", "yx", "zx", "zy")

# Every float32 product that feeds a reported number (DFT flushes, NF2FF
# integrals) runs at full float32 precision: a GPU may otherwise compute
# default-precision matmuls in TF32, which keeps ~3 decimal digits.
HIGHEST = jax.lax.Precision.HIGHEST


def nf_to_complex(stacked, axis: int = 0) -> np.ndarray:
    """Convert a stacked (re, im) float array to complex on host.

    ``axis`` is the position of the 2-wide re/im axis (0 for the engine's
    accumulators; 1 for vmapped sweep outputs whose batch axis leads).
    Complex input passes through. The single definition keeps every
    consumer in sync with the engine's stacked layout."""
    a = np.asarray(stacked)
    if np.iscomplexobj(a):
        return a
    return np.take(a, 0, axis) + 1j * np.take(a, 1, axis)


# ---------------------------------------------------------------------------
# small shape helpers
# ---------------------------------------------------------------------------

def _bdiff(a, axis):
    """Backward difference a[i] − a[i−1]; index 0 yields a[0]."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (1, 0)
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(0, -1)
    return a - jnp.pad(a, pad)[tuple(sl)]


def _fdiff(a, axis):
    """Forward difference a[i+1] − a[i]; last index yields −a[last]."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, 1)
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(1, None)
    return jnp.pad(a, pad)[tuple(sl)] - a


def _bvec(v: np.ndarray, axis: int) -> jnp.ndarray:
    """1D vector broadcast along ``axis`` of a 3D array."""
    shape = [1, 1, 1]
    shape[axis] = len(v)
    return jnp.asarray(v, jnp.float32).reshape(shape)


def _plane(a, axis: int, idx: int):
    sl = [slice(None)] * 3
    sl[axis] = idx
    return a[tuple(sl)]


def _set_plane(a, axis: int, idx: int, val):
    sl = [slice(None)] * 3
    sl[axis] = idx
    return a.at[tuple(sl)].set(val)


# ---------------------------------------------------------------------------
# configuration / prepared-simulation containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FDTDConfig:
    """Run controls (reference analogs: NrTS / EndCriteria / boundary).

    ``boundary``: 'MUR' (first-order ABC, the reference default),
    'PEC' (closed box), or 'PML_N' (N-cell CPML, e.g. 'PML_8' — the
    reference's alternative, solver_fdtd_openems.py:188).
    """

    n_steps_max: int = 30_000
    end_criteria: float = 1e-4
    boundary: str = "MUR"
    check_every: int = 500
    courant: float = 0.95
    dtype: str = "float32"
    # Probe/DFT sampling stride. None → auto: the largest D keeping the
    # sampling interval D·dt below 1/(2.5·(f0+fc)) — i.e. sampling at
    # 2.5× the excitation's −20 dB corner. The margin over Nyquist is
    # 1.25×, which suffices because the Gaussian spectrum falls
    # super-exponentially past the corner (alias-band content sits below
    # 10⁻³ in amplitude; see the builder comment in build_simulation).
    # 1 reproduces openEMS-style per-step sampling.
    probe_decimation: int | None = None

    def pml_cells(self) -> int:
        """0 when not a PML boundary, else the slab thickness in cells."""
        b = self.boundary.upper()
        if not b.startswith("PML"):
            return 0
        try:
            return int(b.split("_")[-1])
        except ValueError:
            return 8


@dataclasses.dataclass
class PortRuntime:
    """Static port geometry consumed by the traced step function."""

    spec: LumpedPortSpec
    axis: int
    sl: Tuple  # index tuple selecting the port's E-edge column
    dl_m: np.ndarray  # (n_edges,) edge lengths
    src_col: np.ndarray  # (n_edges,) source coefficient (× s(t) each step)
    # current probe: 4 static gather tuples + 2 dual lengths
    i_gather: List[Tuple]
    i_lengths: Tuple[float, float]
    # excite=1 basis of src_col; set_port_excitation rescales from it
    src_col_unit: Optional[np.ndarray] = None


@dataclasses.dataclass
class MSLRuntime:
    """Static MSL-port geometry consumed by the traced step function.

    ``sl`` selects the excited block of Ez edges at the excitation plane.
    ``v_probes`` / ``i_probes`` are generic linear-probe source lists
    [((comp, i, j, k), weight)] over the E / H field stacks: three V
    probes on node planes m−1, m, m+1 and two Ampère-loop I probes on
    dual planes m−½, m+½ around the measurement plane (openEMS-style
    3-probe deembedding). ``v_pos_m`` / ``i_pos_m`` are the probe-plane
    coordinates along the propagation axis, in meters.
    """

    spec: object  # models.scene.MSLPortSpec
    sl: Tuple
    src_col: np.ndarray  # filled once cb is known
    v_probes: list  # 3 probe source lists
    i_probes: list  # 2 probe source lists
    v_pos_m: np.ndarray
    i_pos_m: np.ndarray
    z_ref: float
    # excite=1 basis of src_col; set_port_excitation rescales from it
    src_col_unit: Optional[np.ndarray] = None

    # each MSL port occupies this many probe rows in the uf/if_
    # accumulators: (V@m−1, I@m−½), (V@m, I@m+½), (V@m+1, —)
    N_ROWS = 3


def port_probe_sources(sim: "PreparedSimulation"):
    """Generic per-port probe source lists, lumped ports first then MSL.

    Returns (v_lists, i_lists): for each port a list of
    ((comp, i, j, k), weight) terms — V over the E stack, I over the H
    stack. The gather probes of every run path consume this single
    representation.
    """
    Px, Py, Pz = sim.padded_shape or sim.grid.shape
    v_lists, i_lists = [], []
    for prt in sim.ports:
        col = np.stack(
            np.meshgrid(
                *[np.atleast_1d(np.arange((Px, Py, Pz)[a])[prt.sl[a]])
                  for a in range(3)],
                indexing="ij",
            ),
            axis=-1,
        ).reshape(-1, 3)
        v_lists.append([
            ((prt.axis, int(t[0]), int(t[1]), int(t[2])), -float(w))
            for t, w in zip(col, prt.dl_m)
        ])
        dv, du = prt.i_lengths
        hv = (prt.axis + 2) % 3
        hu = (prt.axis + 1) % 3
        g = prt.i_gather
        i_lists.append([
            ((hv, *g[0]), float(dv)), ((hv, *g[1]), -float(dv)),
            ((hu, *g[2]), -float(du)), ((hu, *g[3]), float(du)),
        ])
    for msl in sim.msl_ports:
        # 3 probe rows per MSL port (see MSLRuntime): the V@m+1 row has
        # no paired I probe — its zero-weight gather contributes nothing
        v_lists += msl.v_probes
        i_lists += [msl.i_probes[0], msl.i_probes[1], []]
    return v_lists, i_lists


def n_probe_rows(sim: "PreparedSimulation") -> int:
    """Rows in the uf/if_ port-DFT accumulators: one per lumped port,
    MSLRuntime.N_ROWS per MSL port (3-probe deembedding layout)."""
    return len(sim.ports) + MSLRuntime.N_ROWS * len(sim.msl_ports)


def _build_msl_runtime(spec, grid: YeeGrid) -> MSLRuntime:
    """Resolve an MSL port spec onto the grid.

    Excitation: uniform vertical-E (quasi-TEM) soft source on the plane of
    Ez edges under the strip at ``exc_pos``. Probes use the openEMS-style
    3-probe deembedding layout around ``meas_pos`` (the scheme the
    reference's disabled MSL path would have used, multi_3d.py:458-467):
    three V probes (−∫E·dl at the strip center) on the node planes
    m−1, m, m+1 and two Ampère-loop I probes on the dual planes m−½, m+½.
    Post-processing (post/ports.py:msl_port_spectra) forms centered
    estimates of V, I, dV/dx, dI/dx at the measurement plane and derives
    the line's measured Z_L and β for the traveling-wave split.
    """
    axis = _AXIS_OF[spec.prop_axis]
    if axis == 2:
        raise ValueError("MSL propagation axis must be x or y")
    t_axis = 1 - axis  # the other horizontal axis
    lines = [grid.x, grid.y, grid.z]

    def nearest(ax, val):
        return int(np.argmin(np.abs(lines[ax] - val)))

    exc_i = nearest(axis, spec.exc_pos_mm)
    meas_i = nearest(axis, spec.meas_pos_mm)
    k0 = nearest(2, 0.0)
    kh = nearest(2, spec.height_mm)
    t_lo = spec.strip_center_mm - spec.strip_width_mm / 2
    t_hi = spec.strip_center_mm + spec.strip_width_mm / 2
    t_nodes = np.where(
        (lines[t_axis] >= t_lo - 1e-9) & (lines[t_axis] <= t_hi + 1e-9)
    )[0]
    if len(t_nodes) == 0:
        t_nodes = np.array([nearest(t_axis, spec.strip_center_mm)])
    j_lo, j_hi = int(t_nodes[0]), int(t_nodes[-1])
    jc = nearest(t_axis, spec.strip_center_mm)

    sl = [None, None, None]
    sl[axis] = exc_i
    sl[t_axis] = slice(j_lo, j_hi + 1)
    sl[2] = slice(k0, kh)
    sl = tuple(sl)

    dz = grid.deltas_m("z")
    dd = [grid.dual_deltas_m(n) for n in "xyz"]

    def idx3(a_i, t_j, k):
        out = [0, 0, 0]
        out[axis] = a_i
        out[t_axis] = t_j
        out[2] = k
        return tuple(out)

    def v_probe_at(p):
        """−∫Ez·dl at the strip center on node plane ``p``."""
        return [((2, *idx3(p, jc, k)), -float(dz[k])) for k in range(k0, kh)]

    # propagation direction sign: I measured along exc → meas travel
    direction = 1.0 if spec.meas_pos_mm >= spec.exc_pos_mm else -1.0

    def i_probe_at(p):
        """Ampère loop around the strip sheet using H on dual plane p+½.

        H components: curl_prop = ∂H_t2/∂u − … with (axis, u, v) cyclic.
        For axis=0 (x): curl_x = ∂Hz/∂y − ∂Hy/∂z; for axis=1 (y):
        curl_y = ∂Hx/∂z − ∂Hz/∂x.
        """
        srcs = []
        for j in range(max(j_lo - 1, 1), min(j_hi + 2, len(lines[t_axis]) - 1)):
            if axis == 0:
                base = idx3(p, j, kh)
                jm = idx3(p, j - 1, kh)
                km = idx3(p, j, kh - 1)
                w_t = float(dd[2][kh]) * direction
                w_z = float(dd[t_axis][j]) * direction
                srcs += [
                    ((2, *base), w_t), ((2, *jm), -w_t),   # ΔHz·dzd
                    ((1, *base), -w_z), ((1, *km), w_z),   # −ΔHy·dyd
                ]
            else:  # axis == 1 (propagation along y)
                base = idx3(p, j, kh)
                km = idx3(p, j, kh - 1)
                jm = idx3(p, j - 1, kh)
                w_x = float(dd[t_axis][j]) * direction
                w_z = float(dd[2][kh]) * direction
                srcs += [
                    ((0, *base), w_x), ((0, *km), -w_x),   # ΔHx·dxd
                    ((2, *base), -w_z), ((2, *jm), w_z),   # −ΔHz·dzd
                ]
        return srcs

    if not (1 <= meas_i - 1 and meas_i + 1 < len(lines[axis])):
        raise ValueError(
            "MSL measurement plane too close to the grid edge for the "
            "3-probe deembedding layout"
        )
    ax_mm = np.asarray(lines[axis], np.float64)
    v_planes = [meas_i - 1, meas_i, meas_i + 1]
    i_planes = [meas_i - 1, meas_i]
    return MSLRuntime(
        spec=spec,
        sl=sl,
        src_col=np.zeros((j_hi + 1 - j_lo, kh - k0), np.float32),
        v_probes=[v_probe_at(p) for p in v_planes],
        i_probes=[i_probe_at(p) for p in i_planes],
        v_pos_m=ax_mm[v_planes] * 1e-3,
        i_pos_m=np.array(
            [0.5 * (ax_mm[p] + ax_mm[p + 1]) for p in i_planes]
        ) * 1e-3,
        z_ref=float(spec.z0_ohm),
    )


@dataclasses.dataclass
class FaceRuntime:
    """One Huygens-box face: slicing recipe + geometry for the transform."""

    name: str
    axis: int
    m: int  # node index of the face plane along `axis`
    u_axis: int
    v_axis: int
    u0: int
    u1: int
    v0: int
    v1: int
    normal: np.ndarray  # outward unit normal (3,)
    centers_m: np.ndarray  # (nu, nv, 3) face-cell centers, meters (grid frame)
    areas_m2: np.ndarray  # (nu, nv)


@dataclasses.dataclass
class PreparedSimulation:
    """Compiled simulation: coefficients + jitted chunked time loop.

    The analog of the reference's ``OpenEMSPrepared`` payload (an FDTD
    object plus a sim_path); here it is a pure-array program.
    """

    grid: YeeGrid
    dt: float
    cfg: FDTDConfig
    coeffs: Dict[str, jnp.ndarray]
    waveform: np.ndarray
    ports: List[PortRuntime]
    msl_ports: List["MSLRuntime"]
    faces: List[FaceRuntime]
    port_freqs_hz: np.ndarray
    nf_freqs_hz: np.ndarray
    n_source_steps: int
    f0: float
    fc: float
    padded_shape: Tuple[int, int, int] = None  # array shape incl. zero pad
    probe_decim: int = 1  # probe sampling stride (see FDTDConfig)
    field_sharding: object = None  # optional jax.sharding.NamedSharding
    _host_run: object = None  # host-driven superchunk pipeline
    _aux: tuple = None  # (inv_p, inv_d, mur_coef) kept for run-fn rebuilds
    # per-component source matrices as RUNTIME OPERANDS of the jitted run
    # (set_port_excitation swaps them without re-tracing), and the
    # rebuilder that refreshes them from the ports' src_col
    _src_ops: tuple = ()
    _src_refresh: object = None
    # host (NumPy) copies of ``coeffs``: consumers that need host values
    # (sweep delta builds) read these instead of copying device arrays
    # back
    _coeffs_np: Dict[str, np.ndarray] = None

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.grid.shape

    @property
    def dft_dt(self) -> float:
        """Effective sampling interval of the DFT sums (dt × decimation);
        the factor that turns raw DFT sums into Fourier-integral estimates."""
        return self.dt * self.probe_decim

    def _adapt_resume_arrays(self, resume_state):
        """Crop/zero-pad a resume state's 3D arrays to this sim's padded
        shape.

        Different builds pad the grid differently (e.g. a sharded build
        pads x to a multiple of the device count); the pad region is
        physics-neutral (zero coefficients keep its fields identically
        zero), so cropping it away or re-padding with zeros is exact and a
        checkpoint written under one padding resumes under another.
        """
        tgt = self.padded_shape or self.grid.shape

        def fix(a):
            a = np.asarray(a)
            if a.ndim != 3 or a.shape == tuple(tgt):
                return a
            a = a[tuple(slice(0, min(a.shape[i], tgt[i])) for i in range(3))]
            pads = [(0, tgt[i] - a.shape[i]) for i in range(3)]
            return np.pad(a, pads) if any(p[1] for p in pads) else a

        out = dict(resume_state)
        out["fields"] = tuple(fix(f) for f in resume_state["fields"])
        for grp in ("psi_e", "psi_h"):
            if resume_state.get(grp):
                out[grp] = {k: fix(v) for k, v in resume_state[grp].items()}
        return out

    def _run_args(self):
        return (
            self.coeffs,
            jnp.asarray(self.waveform),
            jnp.asarray(2 * math.pi * self.port_freqs_hz, jnp.float32),
            jnp.asarray(2 * math.pi * self.nf_freqs_hz, jnp.float32),
            self._src_ops,
        )

    def lower_superchunk(self):
        """Lower (without running) one superchunk of the host pipeline
        with this simulation's operands; ``.compile().memory_analysis()``
        of the result reports the device memory the step loop needs."""
        return self._host_run.lower_superchunk(*self._run_args())

    def run(self, resume_state=None, progress_cb=None, abort_cb=None):
        """Execute (or resume) the simulation.

        ``resume_state`` is the ``out["state"]`` pytree of a previous run
        (possibly loaded from a checkpoint file, see ``post.checkpoint``);
        the loop continues from that step count until ``n_steps_max`` or
        the energy criterion.

        ``progress_cb(steps_done, n_steps_max, e_ratio)`` is invoked at
        every superchunk boundary of the host-driven pipeline, and
        ``abort_cb() -> bool`` is checked at the same points — returning
        True stops the run mid-flight; the output then carries
        ``aborted=True`` with the partial DFT state (a valid resume
        checkpoint).
        """
        if resume_state is not None:
            resume_state = self._adapt_resume_arrays(resume_state)
        out = self._host_run(
            *self._run_args(), resume_state=resume_state,
            progress_cb=progress_cb, abort_cb=abort_cb,
        )
        jax.block_until_ready(out["steps"])
        # Fetch only the small outputs eagerly; fields and NF2FF surface
        # accumulators stay on device and transfer lazily on first
        # np.asarray.
        host = dict(out)
        host["uf"] = nf_to_complex(out["uf"])
        host["if_"] = nf_to_complex(out["if_"])
        host.setdefault("aborted", False)
        if progress_cb is not None and not host["aborted"]:
            try:  # final 100% tick
                steps_done = int(out["steps"])
                progress_cb(steps_done, steps_done, float(out["e_ratio"]))
            except Exception:
                pass
        return host


# ---------------------------------------------------------------------------
# CPML (convolutional PML) profiles
# ---------------------------------------------------------------------------

def _cpml_profiles(
    grid: YeeGrid,
    padded_shape: Tuple[int, int, int],
    dt: float,
    npml: int,
    m: float = 3.0,
    r0: float = 1e-8,
    alpha_max: float = 0.05,
):
    """Per-axis recursive-convolution coefficients b, c at node and half
    positions (Roden–Gedney CPML, κ = 1).

    σ is polynomially graded over the *physical* slab depth, so the graded
    mesh needs no special casing; σ_max = −(m+1)·ln(R0)/(2·η0·L_slab) per
    side. α is linearly graded from α_max at the inner interface to 0 at
    the wall (CFS term for low-frequency/evanescent absorption).
    """
    from ..physics import ETA0

    out = {}
    for a, name in enumerate("xyz"):
        lines = grid.lines[name] * grid.unit  # meters
        Q = len(lines)
        P = padded_shape[a]
        if npml * 2 + 4 > Q:
            raise ValueError(
                f"grid axis {name} too small for {npml}-cell PML"
            )
        x_lo, x_hi = lines[npml], lines[Q - 1 - npml]
        L_lo = x_lo - lines[0]
        L_hi = lines[-1] - x_hi
        s_max_lo = -(m + 1.0) * math.log(r0) / (2.0 * ETA0 * L_lo)
        s_max_hi = -(m + 1.0) * math.log(r0) / (2.0 * ETA0 * L_hi)

        prof = {}
        for kind in ("node", "half"):
            pos = np.full(P, 0.5 * (x_lo + x_hi))  # pad slots → interior
            if kind == "node":
                pos[:Q] = lines
            else:
                pos[: Q - 1] = 0.5 * (lines[:-1] + lines[1:])
            d = np.zeros(P)
            s_max = np.zeros(P)
            lo = pos < x_lo
            hi = pos > x_hi
            d[lo] = (x_lo - pos[lo]) / L_lo
            s_max[lo] = s_max_lo
            d[hi] = (pos[hi] - x_hi) / L_hi
            s_max[hi] = s_max_hi
            d = np.clip(d, 0.0, 1.0)
            sigma = s_max * d**m
            alpha = alpha_max * (1.0 - d) * (d > 0)
            b = np.exp(-(sigma + alpha) * dt / EPS0)
            denom = sigma + alpha
            c = np.where(denom > 0, sigma / np.maximum(denom, 1e-30) * (b - 1.0), 0.0)
            prof[kind] = (b.astype(np.float32), c.astype(np.float32))
        out[a] = prof
    return out


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def _build_port_runtime(
    spec: LumpedPortSpec,
    grid: YeeGrid,
    sigma_edges: Dict[str, np.ndarray],
) -> PortRuntime:
    """Resolve a port spec to grid edges; folds its resistance into the
    edge conductivity arrays (mutates ``sigma_edges``) — the Piket-May
    lumped-element formulation: a resistor R across edges of length dl and
    dual area A is exactly an added conductivity σ_p = L_total/(R·A)."""
    axis = _AXIS_OF[spec.direction]
    axes = [0, 1, 2]
    t_axes = [a for a in axes if a != axis]
    lines = [grid.x, grid.y, grid.z]

    def nearest(ax: int, val: float) -> int:
        return int(np.argmin(np.abs(lines[ax] - val)))

    start = np.asarray(spec.start, float)
    stop = np.asarray(spec.stop, float)
    ti = [nearest(a, start[a]) for a in t_axes]
    e0 = nearest(axis, min(start[axis], stop[axis]))
    e1 = nearest(axis, max(start[axis], stop[axis]))
    n_edges = max(1, e1 - e0)

    d_axis = np.diff(lines[axis]) * grid.unit  # primary spacings (m)
    dl = d_axis[e0 : e0 + n_edges]
    dd = [grid.dual_deltas_m("xyz"[a]) for a in range(3)]
    area = dd[t_axes[0]][ti[0]] * dd[t_axes[1]][ti[1]]

    # port edge index tuple
    sl: List = [None, None, None]
    sl[axis] = slice(e0, e0 + n_edges)
    sl[t_axes[0]] = ti[0]
    sl[t_axes[1]] = ti[1]
    sl = tuple(sl)

    # fold resistor conductivity into the E-edge sigma for this component
    comp = "e" + spec.direction
    sigma_p = dl.sum() / (spec.resistance * area)
    sigma_edges[comp][sl] += sigma_p

    # current probe: H loop around the middle edge. With (a, u, v) a cyclic
    # right-handed triple, I = ΔH_v·dd_v − ΔH_u·dd_u  (curl_a × dual area).
    u, v = (axis + 1) % 3, (axis + 2) % 3
    k_mid = e0 + n_edges // 2
    idx = [0, 0, 0]
    idx[axis] = k_mid
    for a, t in zip(t_axes, ti):
        idx[a] = t

    def tup(base, ax, off):
        t2 = list(base)
        t2[ax] += off
        return tuple(t2)

    # curl_a = dH_v/du − dH_u/dv ⇒ I = (Hv[idx]−Hv[idx−û])·dd_u? No:
    # I = (Hv[idx]−Hv[idx−û])·(dd_v?) — lengths pair with the *other* axis:
    # ∮H·dl = (ΔHv/dd_u)·dd_u·dd_v − (ΔHu/dd_v)·dd_u·dd_v
    #       = ΔHv·dd_v ... careful: (∂Hv/∂u)·A/dd_u·... A = dd_u·dd_v so
    # (ΔHv/dd_u)·A = ΔHv·dd_v and (ΔHu/dd_v)·A = ΔHu·dd_u.
    # the Ampère loop needs the H row one cell BELOW the port in both
    # transverse directions — a port flush against the grid wall would
    # produce a −1 index that silently wraps to the opposite wall and
    # corrupts I(t) (and with it Z_in/S11) with no error
    for a in (u, v):
        if idx[a] < 1:
            raise ValueError(
                f"lumped port at {'xyz'[a]}-index {idx[a]} touches the "
                "grid boundary; its current probe needs one cell of "
                "clearance — move the port or extend the grid"
            )
    i_gather = [
        tup(idx, u, 0),  # Hv at idx        (+)
        tup(idx, u, -1),  # Hv at idx − û   (−)
        tup(idx, v, 0),  # Hu at idx        (−)
        tup(idx, v, -1),  # Hu at idx − v̂   (+)
    ]
    i_lengths = (float(dd[v][idx[v]]), float(dd[u][idx[u]]))

    return PortRuntime(
        spec=spec,
        axis=axis,
        sl=sl,
        dl_m=dl,
        src_col=np.zeros_like(dl, dtype=np.float32),  # filled after cb known
        i_gather=i_gather,
        i_lengths=i_lengths,
    )


def _build_faces(
    grid: YeeGrid, box_idx: Tuple[int, int, int, int, int, int]
) -> List[FaceRuntime]:
    i0, i1, j0, j1, k0, k1 = box_idx
    lines_m = [grid.x * grid.unit, grid.y * grid.unit, grid.z * grid.unit]
    d_m = [np.diff(l) for l in lines_m]
    centers_m = [0.5 * (l[:-1] + l[1:]) for l in lines_m]
    lo = {0: i0, 1: j0, 2: k0}
    hi = {0: i1, 1: j1, 2: k1}
    faces: List[FaceRuntime] = []
    for axis in range(3):
        u_axis, v_axis = [a for a in range(3) if a != axis]
        u0, u1 = lo[u_axis], hi[u_axis]
        v0, v1 = lo[v_axis], hi[v_axis]
        cu = centers_m[u_axis][u0:u1]
        cv = centers_m[v_axis][v0:v1]
        dA = np.outer(d_m[u_axis][u0:u1], d_m[v_axis][v0:v1])
        for side, m in (("lo", lo[axis]), ("hi", hi[axis])):
            normal = np.zeros(3)
            normal[axis] = -1.0 if side == "lo" else 1.0
            cpts = np.zeros((len(cu), len(cv), 3))
            cpts[..., axis] = lines_m[axis][m]
            cpts[..., u_axis] = cu[:, None]
            cpts[..., v_axis] = cv[None, :]
            faces.append(
                FaceRuntime(
                    name=f"{'xyz'[axis]}_{side}",
                    axis=axis,
                    m=m,
                    u_axis=u_axis,
                    v_axis=v_axis,
                    u0=u0,
                    u1=u1,
                    v0=v0,
                    v1=v1,
                    normal=normal,
                    centers_m=cpts,
                    areas_m2=dA,
                )
            )
    return faces


def _face_slab(arr, face: FaceRuntime, a_idx: int, u_off: int, v_off: int):
    """Slice arr at plane ``a_idx`` over the face's (u, v) cell window,
    offset by (u_off, v_off)."""
    sl = [None, None, None]
    sl[face.axis] = a_idx
    sl[face.u_axis] = slice(face.u0 + u_off, face.u1 + u_off)
    sl[face.v_axis] = slice(face.v0 + v_off, face.v1 + v_off)
    return arr[tuple(sl)]


def _face_tangential(E, H, face: FaceRuntime):
    """Interpolate tangential E and H onto face-cell centers.

    Returns (E_u, E_v, H_u, H_v), each (nu, nv). E_u is the E component
    along the face's u axis, etc. Second-order staggering-aware averages.
    """
    Eu_arr, Ev_arr = E[face.u_axis], E[face.v_axis]
    Hu_arr, Hv_arr = H[face.u_axis], H[face.v_axis]
    m = face.m
    # E_u: cell-centered along u already; average the two v-nodes.
    E_u = 0.5 * (
        _face_slab(Eu_arr, face, m, 0, 0) + _face_slab(Eu_arr, face, m, 0, 1)
    )
    E_v = 0.5 * (
        _face_slab(Ev_arr, face, m, 0, 0) + _face_slab(Ev_arr, face, m, 1, 0)
    )
    # H_u: cell-centered along v and along `axis`; average axis (m−1, m)
    # and the two u-nodes.
    H_u = 0.25 * (
        _face_slab(Hu_arr, face, m - 1, 0, 0)
        + _face_slab(Hu_arr, face, m, 0, 0)
        + _face_slab(Hu_arr, face, m - 1, 1, 0)
        + _face_slab(Hu_arr, face, m, 1, 0)
    )
    H_v = 0.25 * (
        _face_slab(Hv_arr, face, m - 1, 0, 0)
        + _face_slab(Hv_arr, face, m, 0, 0)
        + _face_slab(Hv_arr, face, m - 1, 0, 1)
        + _face_slab(Hv_arr, face, m, 0, 1)
    )
    return E_u, E_v, H_u, H_v


def build_simulation(
    scene: Scene,
    grid: YeeGrid,
    *,
    f0: float,
    fc: float,
    cfg: FDTDConfig = FDTDConfig(),
    port_freqs_hz: Optional[np.ndarray] = None,
    nf_freqs_hz: Optional[np.ndarray] = None,
    nf_margin_cells: int = 4,
    nf_box_idx: Optional[Tuple[int, int, int, int, int, int]] = None,
    pad_multiple: Tuple[int, int, int] = (1, 1, 1),
) -> PreparedSimulation:
    """Voxelize + coefficients + jitted chunked time loop (prepare phase).

    ``pad_multiple`` zero-pads every 3D array so each axis is a multiple of
    the given value — physics is unaffected (Ca=Cb=0 and zero inverse
    spacings in the pad keep fields identically zero there). Used for
    device-count divisibility when sharding.
    """
    Px, Py, Pz = grid.shape
    dt = grid.courant_dt(cfg.courant)

    vox = voxelize(scene, grid)

    # --- per-edge material arrays -----------------------------------------
    sigma_edges = {
        "ex": cell_to_edge_average(vox.sigma, "ex"),
        "ey": cell_to_edge_average(vox.sigma, "ey"),
        "ez": cell_to_edge_average(vox.sigma, "ez"),
    }
    # finite-conductivity metallization: per-edge added conductivity from
    # ConductiveSheet primitives (subcell thin-sheet model; conductor loss
    # then appears physically in the power balance)
    for comp, sheet in (("ex", vox.sheet_sigma_ex),
                        ("ey", vox.sheet_sigma_ey),
                        ("ez", vox.sheet_sigma_ez)):
        if sheet is not None:
            sigma_edges[comp] = sigma_edges[comp] + sheet
    eps_edges = {
        c: cell_to_edge_average(vox.eps_r, c) * EPS0 for c in ("ex", "ey", "ez")
    }

    # --- ports fold their resistance into sigma ---------------------------
    ports = [_build_port_runtime(p, grid, sigma_edges) for p in scene.ports]
    msl_ports = [_build_msl_runtime(m, grid) for m in scene.msl_ports]

    # --- Ca/Cb per component ----------------------------------------------
    pec = {"ex": vox.pec_ex, "ey": vox.pec_ey, "ez": vox.pec_ez}
    coeffs: Dict[str, jnp.ndarray] = {}
    coeffs_np: Dict[str, np.ndarray] = {}  # host copies (see _coeffs_np)
    mur = cfg.boundary.upper().startswith("MUR")
    for comp, d_axis in (("ex", 0), ("ey", 1), ("ez", 2)):
        eps_a = eps_edges[comp]
        sig_a = sigma_edges[comp]
        beta = sig_a * dt / (2.0 * eps_a)
        ca = (1.0 - beta) / (1.0 + beta)
        cb = (dt / eps_a) / (1.0 + beta)
        # invalid trailing slot along the component's own axis
        sl = [slice(None)] * 3
        sl[d_axis] = -1
        ca[tuple(sl)] = 0.0
        cb[tuple(sl)] = 0.0
        # outer boundary planes tangential to this component
        for b_axis in (a for a in range(3) if a != d_axis):
            for idx in (0, grid.shape[b_axis] - 1):
                slb = [slice(None)] * 3
                slb[b_axis] = idx
                cb[tuple(slb)] = 0.0
                ca[tuple(slb)] = 1.0 if mur else 0.0
        # PEC objects win last
        ca[pec[comp]] = 0.0
        cb[pec[comp]] = 0.0
        coeffs_np["ca_" + comp] = ca.astype(np.float32, copy=False)
        coeffs_np["cb_" + comp] = cb.astype(np.float32, copy=False)

    # --- MSL excitation patterns (need cb): uniform quasi-TEM profile ----
    # ``src_col_unit`` is the excite=1 basis column; re-excitation
    # (set_port_excitation, used by the S-matrix extractor) rescales
    # src_col from it without re-voxelizing.
    for msl in msl_ports:
        cb_host = coeffs_np["cb_ez"]
        msl.src_col_unit = cb_host[msl.sl].astype(np.float32)
        msl.src_col = (msl.src_col_unit * msl.spec.excite).astype(np.float32)

    # --- port source columns (need cb) ------------------------------------
    for prt in ports:
        comp = "e" + prt.spec.direction
        cb_host = coeffs_np["cb_" + comp]
        cb_col = cb_host[prt.sl]
        t_axes = [a for a in range(3) if a != prt.axis]
        dd = [grid.dual_deltas_m("xyz"[a]) for a in range(3)]
        idx_probe = prt.i_gather[0]
        area = dd[t_axes[0]][idx_probe[t_axes[0]]] * dd[t_axes[1]][idx_probe[t_axes[1]]]
        prt.src_col_unit = (
            cb_col / (prt.spec.resistance * area)
        ).astype(np.float32)
        prt.src_col = (
            prt.src_col_unit * prt.spec.excite
        ).astype(np.float32)

    # --- zero padding for shard divisibility -------------------------------
    padded_shape = tuple(
        int(-(-grid.shape[a] // pad_multiple[a]) * pad_multiple[a])
        for a in range(3)
    )
    if padded_shape != grid.shape:
        pads = tuple(padded_shape[a] - grid.shape[a] for a in range(3))
        coeffs_np = {
            k: np.pad(v, [(0, pads[0]), (0, pads[1]), (0, pads[2])])
            for k, v in coeffs_np.items()
        }
    # single host→device upload per array; padding stays on the host so
    # callers that need host copies (sweep delta builds) never read
    # device arrays back
    coeffs = {k: jnp.asarray(v) for k, v in coeffs_np.items()}

    # --- inverse spacing vectors -------------------------------------------
    inv_p, inv_d = {}, {}
    for a, name in enumerate("xyz"):
        d = grid.deltas_m(name)
        ip = np.zeros(padded_shape[a], np.float32)
        ip[: len(d)] = 1.0 / d
        inv_p[a] = ip
        idv = np.zeros(padded_shape[a], np.float32)
        idv[: grid.shape[a]] = 1.0 / grid.dual_deltas_m(name)
        inv_d[a] = idv

    # --- MUR face coefficients ----------------------------------------------
    mur_coef = {}
    for a, name in enumerate("xyz"):
        d = grid.deltas_m(name)
        mur_coef[(a, 0)] = float((C0 * dt - d[0]) / (C0 * dt + d[0]))
        mur_coef[(a, 1)] = float((C0 * dt - d[-1]) / (C0 * dt + d[-1]))

    # --- CPML profiles -------------------------------------------------------
    npml = cfg.pml_cells()
    pml = (
        _cpml_profiles(grid, padded_shape, dt, npml) if npml > 0 else None
    )

    # --- NF2FF faces ----------------------------------------------------------
    if nf_box_idx is None:
        m = max(nf_margin_cells, npml + 3)  # keep the box out of the PML
        nf_box_idx = (m, Px - 1 - m, m, Py - 1 - m, m, Pz - 1 - m)
    faces = _build_faces(grid, nf_box_idx)

    # --- excitation ------------------------------------------------------------
    from .source import gaussian_excitation

    n_src = source_active_steps(f0, fc, dt)
    # the waveform must cover the FULL source duration, not just
    # n_steps_max: a sim built with a small step budget would otherwise
    # silently truncate the source, and a checkpoint taken from it could
    # never resume to the same physics as an uninterrupted run (the
    # missing samples are gone). A few thousand float32s cost nothing.
    waveform = gaussian_excitation(
        f0, fc, dt, max(int(cfg.n_steps_max), n_src))

    if port_freqs_hz is None:
        port_freqs_hz = np.linspace(max(1e8, f0 * 0.5), f0 * 1.5, 201)
    if nf_freqs_hz is None:
        nf_freqs_hz = np.linspace(f0 * 0.85, f0 * 1.15, 11)
    port_freqs_hz = np.asarray(port_freqs_hz, np.float64)
    nf_freqs_hz = np.asarray(nf_freqs_hz, np.float64)

    if cfg.probe_decimation is not None:
        probe_decim = max(1, int(cfg.probe_decimation))
    else:
        # 2.5x the -20 dB corner: content that could alias back sits at
        # ≥1.8·fc beyond the corner, where the Gaussian envelope is below
        # 10^-3 in amplitude.
        probe_decim = max(1, int(1.0 / (2.5 * (f0 + fc) * dt)))
    probe_decim = min(probe_decim, max(1, int(cfg.check_every)))

    sim = PreparedSimulation(
        grid=grid,
        dt=dt,
        cfg=cfg,
        coeffs=coeffs,
        waveform=waveform,
        ports=ports,
        msl_ports=msl_ports,
        faces=faces,
        port_freqs_hz=port_freqs_hz,
        nf_freqs_hz=nf_freqs_hz,
        n_source_steps=n_src,
        f0=f0,
        fc=fc,
        padded_shape=padded_shape,
        probe_decim=probe_decim,
        _coeffs_np=coeffs_np,
    )
    sim._aux = (inv_p, inv_d, mur_coef, pml)
    rebuild_run_fn(sim)
    return sim


def rebuild_run_fn(sim: "PreparedSimulation") -> None:
    """(Re)build the run pipeline (e.g. after attaching a field sharding)."""
    inv_p, inv_d, mur_coef, pml = sim._aux
    _run_raw = _make_run_fn(sim, inv_p, inv_d, mur_coef, pml)
    sim._host_run = _run_raw.host_run
    sim._src_refresh = _run_raw.build_src_ops
    sim._src_ops = sim._src_refresh()


def set_port_excitation(sim: "PreparedSimulation", scales) -> None:
    """Re-excite a prepared simulation without re-voxelizing.

    ``scales`` gives the new excitation amplitude of every port (lumped
    ports first, then MSL ports — the same order as the uf/if_ probe
    rows' port grouping). The port *loads* are untouched: a lumped
    port's resistance lives in the σ of its cells (folded in at
    coefficient build), so a port re-excited to 0.0 remains a matched
    resistive termination — exactly what S-parameter extraction needs.
    Geometry, mesh, coefficients, NF2FF setup, probe layout AND the
    compiled program are all reused: the source matrices are runtime
    operands of every run path, so this only refreshes ``sim._src_ops``
    (same shapes → jit cache hit). N-port S-matrix extraction therefore
    costs 1 compile + N runs.

    Reference analog: none. openEMS exposes per-port ``excite`` only at
    scene-build time, and the reference never varies it
    (``multi_3d.py:122-124`` drives every port identically).
    """
    n = len(sim.ports) + len(sim.msl_ports)
    scales = list(np.asarray(scales, np.float64).ravel())
    if len(scales) != n:
        raise ValueError(f"expected {n} port scales, got {len(scales)}")
    for p, s in zip(list(sim.ports) + list(sim.msl_ports), scales):
        if p.src_col_unit is None:  # pre-rebuild sims (old checkpoints)
            raise ValueError("simulation lacks src_col_unit basis columns")
        p.src_col = (p.src_col_unit * np.float32(s)).astype(np.float32)
    if sim._src_refresh is None:  # older pickles: fall back to rebuild
        rebuild_run_fn(sim)
    else:
        sim._src_ops = sim._src_refresh()


def make_single_step(sim: "PreparedSimulation"):
    """Expose one jittable leapfrog step + its example arguments.

    Returns ``(step_fn, example_args)`` where
    ``step_fn(carry, n, coeffs, waveform) -> (carry, probes)`` is the full
    per-iteration field computation (H/E updates, boundary treatment, port
    source, probe sampling). Used by the driver's compile check and by
    sharding dry runs.
    """
    inv_p, inv_d, mur_coef, pml = sim._aux
    field_step, init_carry = _make_run_fn(
        sim, inv_p, inv_d, mur_coef, pml, _expose_step=True
    )
    n_pf = len(sim.port_freqs_hz)
    n_nf = len(sim.nf_freqs_hz)
    carry = init_carry(sim.coeffs, n_nf, n_pf)
    args = (
        carry,
        jnp.int32(0),
        sim.coeffs,
        jnp.asarray(sim.waveform),
    )
    return field_step, args


def build_probe_gathers(sim: "PreparedSimulation", Px: int, Py: int,
                        Pz: int):
    """Flat gather indices + weights for every probe quantity.

    Indices address the flattened stack of the six (Px, Py, Pz) field
    arrays (E then H, component-major). Returns ``(pg_e_idx, pg_e_w,
    pg_h_idx, pg_h_w, face_layout, T_faces, pv_idx, pv_w, pi_idx, pi_w)``
    — face tangential E/H gathers (with the per-face slot layout), and
    per-port V/I gathers. Shared by the single-device step and the
    explicit-collective shard_map path (which localizes the indices per
    device).
    """
    faces = sim.faces
    nf_shapes = [(f.u1 - f.u0, f.v1 - f.v0) for f in faces]
    n_ports = n_probe_rows(sim)

    def _flat_idx(comp, i, j, k):
        return ((comp * Px + i) * Py + j) * Pz + k

    e_idx, e_w, h_idx, h_w = [], [], [], []
    layout = []
    off = 0
    for face, (nu, nv) in zip(faces, nf_shapes):
        a, m = face.axis, face.m
        ua, va = face.u_axis, face.v_axis
        uu = np.arange(face.u0, face.u1)
        vv = np.arange(face.v0, face.v1)
        U, V = np.meshgrid(uu, vv, indexing="ij")

        def coords(a_i, u_off, v_off):
            c = [None, None, None]
            c[a] = np.full_like(U, a_i)
            c[ua] = U + u_off
            c[va] = V + v_off
            return c

        def eidx(comp, a_i, u_off, v_off):
            c = coords(a_i, u_off, v_off)
            return _flat_idx(comp, c[0], c[1], c[2]).ravel()

        # E_u then E_v (comp-major, row-major within), matching the
        # (2, nu, nv) per-face accumulator layout
        e_idx.append(np.stack([eidx(ua, m, 0, 0), eidx(ua, m, 0, 1)], -1))
        e_idx.append(np.stack([eidx(va, m, 0, 0), eidx(va, m, 1, 0)], -1))
        e_w.extend([np.full((nu * nv, 2), 0.5, np.float32)] * 2)
        h_idx.append(np.stack([
            eidx(ua, m - 1, 0, 0), eidx(ua, m, 0, 0),
            eidx(ua, m - 1, 1, 0), eidx(ua, m, 1, 0)], -1))
        h_idx.append(np.stack([
            eidx(va, m - 1, 0, 0), eidx(va, m, 0, 0),
            eidx(va, m - 1, 0, 1), eidx(va, m, 0, 1)], -1))
        h_w.extend([np.full((nu * nv, 4), 0.25, np.float32)] * 2)
        layout.append((off, nu, nv))
        off += 2 * nu * nv
    pg_e_idx = np.concatenate(e_idx)
    pg_e_w = np.concatenate(e_w)
    pg_h_idx = np.concatenate(h_idx)
    pg_h_w = np.concatenate(h_w)
    T_faces = off

    # port probes as gathers from the generic per-port source lists
    # (lumped ports first, then MSL — see port_probe_sources)
    v_lists, i_lists = port_probe_sources(sim)

    def _pack_sources(lists):
        S = max([1] + [len(l) for l in lists])
        idx = np.zeros((n_ports, S), np.int64)
        w = np.zeros((n_ports, S), np.float32)
        for piNo, lst in enumerate(lists):
            for e, ((comp, ii, jj, kk), weight) in enumerate(lst):
                idx[piNo, e] = _flat_idx(comp, ii, jj, kk)
                w[piNo, e] = weight
        return idx, w

    pv_idx, pv_w = _pack_sources(v_lists)
    pi_idx, pi_w = _pack_sources(i_lists)
    return (pg_e_idx, pg_e_w, pg_h_idx, pg_h_w, layout, T_faces,
            pv_idx, pv_w, pi_idx, pi_w)


def build_src_mats(sim: "PreparedSimulation", Px: int, Py: int, Pz: int):
    """Per-component dense source matrices, keyed by E component index
    (0/1/2): every lumped-port column and MSL plane folded into ONE
    (Px, Py, Pz) stamp per excited component — one fused FMA per
    component in the step instead of per-port dynamic-update-slices."""
    src_mats = {}
    for prt in sim.ports:
        mat = src_mats.setdefault(prt.axis, np.zeros((Px, Py, Pz), np.float32))
        mat[prt.sl] += prt.src_col
    for msl in sim.msl_ports:
        mat = src_mats.setdefault(2, np.zeros((Px, Py, Pz), np.float32))
        mat[msl.sl] += msl.src_col
    return src_mats


# ---------------------------------------------------------------------------
# the time loop
# ---------------------------------------------------------------------------

def _rescale_resume_dfts(resume_state, new_decim):
    """Pop the checkpoint's probe decimation and rescale its DFT sums.

    Post-processing multiplies the final sums by ``dft_dt = dt·decim`` to
    form Fourier-integral estimates. If the resuming sim resolves a
    DIFFERENT probe decimation (e.g. a different ``check_every`` caps it),
    the old sums were built at the old cadence — scale them by old/new so
    their contribution stays a correct integral under the new factor. Old
    checkpoints without a "decim" key are assumed cadence-matched."""
    resume_state = dict(resume_state)
    old = resume_state.pop("decim", None)
    if old is None:
        return resume_state
    scale = jnp.asarray(old, jnp.float32) / np.float32(new_decim)
    for k in ("uf", "if_", "nf_e", "nf_h"):
        resume_state[k] = jnp.asarray(resume_state[k]) * scale
    return resume_state


def dft_flush(acc, bufs, n0, w_port, w_nf, n_sub: int, decim: int,
              dt: float):
    """Add one termination chunk's staged probe samples to the DFT sums.

    ``acc`` holds the stacked (re, im) accumulators ``uf``/``if_``
    (2, n_ports, Nf) and ``nf_e``/``nf_h`` (2, Nf, T_faces); ``bufs``
    the chunk's ``n_sub`` samples. Sample j sits after step
    n0 + (j+1)·decim — E-state at that time, H-state half a step
    earlier. The phasor products run at HIGHEST precision (see
    :data:`HIGHEST`). Shared by every run path, so the paths cannot
    drift.
    """
    j_idx = jnp.arange(n_sub, dtype=jnp.float32)
    t_e = (n0.astype(jnp.float32) + (j_idx + 1.0) * decim) * np.float32(dt)
    t_h = t_e - np.float32(0.5 * dt)

    def dft(w, t, samples):
        ang = w[:, None] * t[None, :]  # (Nf, K)
        re = jnp.matmul(jnp.cos(ang), samples, precision=HIGHEST)
        im = jnp.matmul(jnp.sin(ang), samples, precision=HIGHEST)
        return jnp.stack([re, -im])

    return dict(
        uf=acc["uf"] + dft(w_port, t_e, bufs["v"]).transpose(0, 2, 1),
        if_=acc["if_"] + dft(w_port, t_h, bufs["i"]).transpose(0, 2, 1),
        nf_e=acc["nf_e"] + dft(w_nf, t_e, bufs["fe"]),
        nf_h=acc["nf_h"] + dft(w_nf, t_h, bufs["fh"]),
    )


def _make_run_fn(sim: PreparedSimulation, inv_p, inv_d, mur_coef, pml=None,
                 _expose_step=False):
    grid = sim.grid
    Px, Py, Pz = sim.padded_shape or grid.shape
    cfg = sim.cfg
    dt = sim.dt
    dtmu = np.float32(dt / MU0)
    mur = cfg.boundary.upper().startswith("MUR")
    ports = sim.ports
    faces = sim.faces
    n_ports = n_probe_rows(sim)
    n_src = sim.n_source_steps
    decim = int(sim.probe_decim)
    n_sub = max(1, int(cfg.check_every) // decim)
    chunk = n_sub * decim  # steps per termination-check chunk
    n_chunks_max = int(math.ceil(cfg.n_steps_max / chunk))

    ix_p, iy_p, iz_p = (_bvec(inv_p[a], a) for a in range(3))
    ix_d, iy_d, iz_d = (_bvec(inv_d[a], a) for a in range(3))

    port_sl = [p.sl for p in ports]
    port_dl = [jnp.asarray(p.dl_m, jnp.float32) for p in ports]

    # Source patterns as dense per-component matrices (build_src_mats).
    # The matrices are RUNTIME OPERANDS of every run path (not traced
    # constants): re-exciting the ports — the S-matrix extractor's N
    # one-hot runs — swaps arrays of identical shape through the jit
    # cache instead of re-tracing, so N-port extraction costs 1 compile
    # + N runs. Only the *component key set* is static (it includes every
    # port regardless of its current excitation amplitude).
    src_comps = sorted(build_src_mats(sim, Px, Py, Pz))

    def build_src_ops():
        """Per-component source matrices from the ports' CURRENT
        ``src_col``, as device arrays. ``set_port_excitation`` calls this
        to refresh ``sim._src_ops`` — same shapes/dtypes, so the jitted
        run is reused verbatim (no re-trace, no recompile)."""
        mats = build_src_mats(sim, Px, Py, Pz)
        return tuple(jnp.asarray(mats[c]) for c in src_comps)

    _src_const_cache: list = []

    def _src_const():
        """Baked source operands for the exposed-step API
        (make_single_step / the adjoint differentiable loop), where the
        excitation is part of the physics being traced. Only the HOST
        matrices are cached — the jnp conversion must happen inside the
        caller's trace (a cached traced constant would leak across
        jit/grad traces as an UnexpectedTracerError)."""
        if not _src_const_cache:
            mats = build_src_mats(sim, Px, Py, Pz)
            _src_const_cache.append([mats[c] for c in src_comps])
        return tuple(jnp.asarray(m) for m in _src_const_cache[0])

    # CPML recursive-convolution coefficients: E-side derivatives live on
    # node positions, H-side on half positions, broadcast along their axis.
    if pml is not None:
        bh = {a: _bvec(pml[a]["half"][0], a) for a in range(3)}
        ch = {a: _bvec(pml[a]["half"][1], a) for a in range(3)}
        be = {a: _bvec(pml[a]["node"][0], a) for a in range(3)}
        ce = {a: _bvec(pml[a]["node"][1], a) for a in range(3)}

    def h_update(E, H, psi_h):
        Ex, Ey, Ez = E
        Hx, Hy, Hz = H
        dEz_y = _fdiff(Ez, 1) * iy_p
        dEy_z = _fdiff(Ey, 2) * iz_p
        dEx_z = _fdiff(Ex, 2) * iz_p
        dEz_x = _fdiff(Ez, 0) * ix_p
        dEy_x = _fdiff(Ey, 0) * ix_p
        dEx_y = _fdiff(Ex, 1) * iy_p
        if pml is not None:
            psi_h = dict(
                xy=bh[1] * psi_h["xy"] + ch[1] * dEz_y,
                xz=bh[2] * psi_h["xz"] + ch[2] * dEy_z,
                yz=bh[2] * psi_h["yz"] + ch[2] * dEx_z,
                yx=bh[0] * psi_h["yx"] + ch[0] * dEz_x,
                zx=bh[0] * psi_h["zx"] + ch[0] * dEy_x,
                zy=bh[1] * psi_h["zy"] + ch[1] * dEx_y,
            )
            Hx = Hx - dtmu * ((dEz_y + psi_h["xy"]) - (dEy_z + psi_h["xz"]))
            Hy = Hy - dtmu * ((dEx_z + psi_h["yz"]) - (dEz_x + psi_h["yx"]))
            Hz = Hz - dtmu * ((dEy_x + psi_h["zx"]) - (dEx_y + psi_h["zy"]))
        else:
            Hx = Hx - dtmu * (dEz_y - dEy_z)
            Hy = Hy - dtmu * (dEx_z - dEz_x)
            Hz = Hz - dtmu * (dEy_x - dEx_y)
        return (Hx, Hy, Hz), psi_h

    def e_update(E, H, coeffs, s_val, psi_e, src_ops):
        Ex, Ey, Ez = E
        Hx, Hy, Hz = H
        dHz_y = _bdiff(Hz, 1) * iy_d
        dHy_z = _bdiff(Hy, 2) * iz_d
        dHx_z = _bdiff(Hx, 2) * iz_d
        dHz_x = _bdiff(Hz, 0) * ix_d
        dHy_x = _bdiff(Hy, 0) * ix_d
        dHx_y = _bdiff(Hx, 1) * iy_d
        if pml is not None:
            psi_e = dict(
                xy=be[1] * psi_e["xy"] + ce[1] * dHz_y,
                xz=be[2] * psi_e["xz"] + ce[2] * dHy_z,
                yz=be[2] * psi_e["yz"] + ce[2] * dHx_z,
                yx=be[0] * psi_e["yx"] + ce[0] * dHz_x,
                zx=be[0] * psi_e["zx"] + ce[0] * dHy_x,
                zy=be[1] * psi_e["zy"] + ce[1] * dHx_y,
            )
            Ex_n = coeffs["ca_ex"] * Ex + coeffs["cb_ex"] * (
                (dHz_y + psi_e["xy"]) - (dHy_z + psi_e["xz"])
            )
            Ey_n = coeffs["ca_ey"] * Ey + coeffs["cb_ey"] * (
                (dHx_z + psi_e["yz"]) - (dHz_x + psi_e["yx"])
            )
            Ez_n = coeffs["ca_ez"] * Ez + coeffs["cb_ez"] * (
                (dHy_x + psi_e["zx"]) - (dHx_y + psi_e["zy"])
            )
        else:
            Ex_n = coeffs["ca_ex"] * Ex + coeffs["cb_ex"] * (dHz_y - dHy_z)
            Ey_n = coeffs["ca_ey"] * Ey + coeffs["cb_ey"] * (dHx_z - dHz_x)
            Ez_n = coeffs["ca_ez"] * Ez + coeffs["cb_ez"] * (dHy_x - dHx_y)
        En = [Ex_n, Ey_n, Ez_n]
        # port soft sources (lumped columns + MSL planes) as fused FMAs
        for comp, mat in zip(src_comps, src_ops):
            En[comp] = En[comp] + mat * s_val
        if mur:
            Eo = [Ex, Ey, Ez]
            for b_axis in range(3):
                for side, (idx, nb) in enumerate(
                    (((0), 1), ((grid.shape[b_axis] - 1), grid.shape[b_axis] - 2))
                ):
                    c = np.float32(mur_coef[(b_axis, side)])
                    for comp in range(3):
                        if comp == b_axis:
                            continue
                        new = _plane(Eo[comp], b_axis, nb) + c * (
                            _plane(En[comp], b_axis, nb)
                            - _plane(Eo[comp], b_axis, idx)
                        )
                        En[comp] = _set_plane(En[comp], b_axis, idx, new)
        return tuple(En), psi_e

    def port_voltage(E):
        # U = −∫E·dl along the port direction (lumped ports only; the run
        # path samples all ports — incl. MSL — via the generic gathers)
        return jnp.stack(
            [-(E[p.axis][port_sl[pi]] * port_dl[pi]).sum() for pi, p in enumerate(ports)]
        ) if ports else jnp.zeros((0,), jnp.float32)

    def port_current(H):
        vals = []
        for p in ports:
            Hv = H[(p.axis + 2) % 3]
            Hu = H[(p.axis + 1) % 3]
            dv, du = p.i_lengths
            i_val = (Hv[p.i_gather[0]] - Hv[p.i_gather[1]]) * np.float32(dv) - (
                Hu[p.i_gather[2]] - Hu[p.i_gather[3]]
            ) * np.float32(du)
            vals.append(i_val)
        return jnp.stack(vals) if ports else jnp.zeros((0,), jnp.float32)

    # ---- gather-based probe sampling ------------------------------------
    # Every probe quantity (tangential face fields, port V, port I) is a
    # fixed linear combination of 2-4 field entries. Precomputing flat
    # gather indices + weights turns probe extraction into two big gathers
    # per sample instead of ~100 tiny slicing ops.
    (pg_e_idx, pg_e_w, pg_h_idx, pg_h_w, face_layout, T_faces,
     pv_idx, pv_w, pi_idx, pi_w) = build_probe_gathers(sim, Px, Py, Pz)

    pg_e_idx = jnp.asarray(pg_e_idx, jnp.int32)
    pg_e_w = jnp.asarray(pg_e_w)
    pg_h_idx = jnp.asarray(pg_h_idx, jnp.int32)
    pg_h_w = jnp.asarray(pg_h_w)
    pv_idx_j = jnp.asarray(pv_idx, jnp.int32)
    pv_w_j = jnp.asarray(pv_w)
    pi_idx_j = jnp.asarray(pi_idx, jnp.int32)
    pi_w_j = jnp.asarray(pi_w)

    def sample_probes(E, H):
        """(face_e (T,), face_h (T,), v (n_ports,), i (n_ports,))."""
        Ecat = jnp.stack(E).reshape(-1)
        Hcat = jnp.stack(H).reshape(-1)
        fe = (Ecat[pg_e_idx] * pg_e_w).sum(-1)
        fh = (Hcat[pg_h_idx] * pg_h_w).sum(-1)
        v = (Ecat[pv_idx_j] * pv_w_j).sum(-1)
        i = (Hcat[pi_idx_j] * pi_w_j).sum(-1)
        return fe, fh, v, i

    def init_carry(coeffs, n_nf_freqs, n_port_freqs):
        def zeros():
            z = jnp.zeros((Px, Py, Pz), jnp.float32)
            if sim.field_sharding is not None:
                z = jax.lax.with_sharding_constraint(z, sim.field_sharding)
            return z

        # DFT accumulators are stacked (re, im) float32: complex64 is
        # kept off every jit boundary, so every backend can allocate and
        # transfer them.
        fields = tuple(zeros() for _ in range(6))
        uf = jnp.zeros((2, n_ports, n_port_freqs), jnp.float32)
        if_ = jnp.zeros((2, n_ports, n_port_freqs), jnp.float32)
        # single flat accumulators over all face slots (split per face on
        # output); see the gather-based probe sampling above
        nf_e = jnp.zeros((2, n_nf_freqs, T_faces), jnp.float32)
        nf_h = jnp.zeros((2, n_nf_freqs, T_faces), jnp.float32)
        psi_e = {k: zeros() for k in PSI_KEYS} if pml is not None else {}
        psi_h = {k: zeros() for k in PSI_KEYS} if pml is not None else {}
        return dict(
            fields=fields,
            uf=uf,
            if_=if_,
            nf_e=nf_e,
            nf_h=nf_h,
            psi_e=psi_e,
            psi_h=psi_h,
            n=jnp.int32(0),
            e_max=jnp.float32(0.0),
            e_ratio=jnp.float32(1.0),
            done=jnp.bool_(False),
        )

    def field_step(carry_in, n, coeffs, waveform, src_ops=None):
        """One leapfrog iteration: H half-step, then E half-step with port
        source + boundary treatment. Returns the new carry plus the probe
        samples (port V/I and Huygens-face tangential fields) for this
        step — DFT accumulation happens per chunk as matmuls, not here.
        ``src_ops=None`` (the exposed-step API) bakes the current source
        matrices as constants; the run paths pass them as operands."""
        if src_ops is None:
            src_ops = _src_const()
        E = carry_in["fields"][:3]
        H = carry_in["fields"][3:]
        Hn, psi_h = h_update(E, H, carry_in["psi_h"])
        i_vals = port_current(Hn)
        s_val = waveform[n]
        En, psi_e = e_update(E, Hn, coeffs, s_val, carry_in["psi_e"],
                             src_ops)
        v_vals = port_voltage(En)
        probes = dict(
            v=v_vals,
            i=i_vals,
            faces_e=[],
            faces_h=[],
        )
        for face in faces:
            E_u, E_v, H_u, H_v = _face_tangential(En, Hn, face)
            probes["faces_e"].append(jnp.stack([E_u, E_v]))  # (2, nu, nv)
            probes["faces_h"].append(jnp.stack([H_u, H_v]))
        carry_out = dict(
            carry_in,
            fields=tuple(En) + tuple(Hn),
            psi_e=psi_e,
            psi_h=psi_h,
        )
        return carry_out, probes

    if _expose_step:
        return field_step, init_carry

    def _flush_and_check(carry, bufs, n0, w_port, w_nf):
        """Shared tail of every termination chunk: the chunked DFT flush
        followed by the energy-decay termination check. Used by both the
        traced while_loop body and the host-driven superchunk pipeline so
        the two paths cannot drift."""
        acc = dft_flush(carry, bufs, n0, w_port, w_nf, n_sub, decim, dt)
        E = carry["fields"][:3]
        energy = sum(jnp.sum(e * e) for e in E)
        e_max = jnp.maximum(carry["e_max"], energy)
        ratio = jnp.where(e_max > 0, energy / e_max, jnp.float32(1.0))
        done = (ratio < np.float32(cfg.end_criteria)) & (
            carry["n"] > np.int32(n_src)
        )
        return dict(carry, **acc, e_max=e_max, e_ratio=ratio, done=done)

    def _assemble_output(carry, n_nf_freqs):
        """Output dict + resumable state (fields/ψ in the padded 3D
        layout; the cadence tag lets a resume under a different probe
        decimation rescale the DFT sums)."""
        state_keys = ("psi_e", "psi_h", "uf", "if_", "nf_e",
                      "nf_h", "n", "e_max", "e_ratio")
        state = {k: carry[k] for k in state_keys}
        state["decim"] = np.int32(decim)
        state["fields"] = carry["fields"]

        def split_faces(acc):
            return [
                acc[:, :, off : off + 2 * nu * nv].reshape(
                    2, n_nf_freqs, 2, nu, nv
                )
                for (off, nu, nv) in face_layout
            ]

        return dict(
            uf=carry["uf"],
            if_=carry["if_"],
            nf_e=split_faces(carry["nf_e"]),
            nf_h=split_faces(carry["nf_h"]),
            steps=carry["n"],
            e_ratio=carry["e_ratio"],
            fields=carry["fields"],
            state=state,
        )

    def _pad_waveform(waveform):
        """Pad the waveform with trailing zeros out to a whole number of
        chunks: the final chunk may overrun n_steps_max, and
        ``waveform[n]`` (clamp-to-last) would otherwise replay the last
        source sample instead of injecting zeros."""
        wf_len = n_chunks_max * chunk
        if waveform.shape[0] < wf_len:
            waveform = jnp.concatenate(
                [waveform,
                 jnp.zeros((wf_len - waveform.shape[0],), waveform.dtype)]
            )
        return waveform

    def _step_body(coeffs, waveform, src_ops):
        def step_body(_, c):
            c2, _probes = field_step(c, c["n"], coeffs, waveform, src_ops)
            c2["n"] = c["n"] + 1
            return c2

        return step_body

    def _empty_bufs():
        return dict(
            v=jnp.zeros((n_sub, n_ports), jnp.float32),
            i=jnp.zeros((n_sub, n_ports), jnp.float32),
            fe=jnp.zeros((n_sub, T_faces), jnp.float32),
            fh=jnp.zeros((n_sub, T_faces), jnp.float32),
        )

    def _staged_sub_body(advance):
        """fori body: advance one decimation window, then stage the probe
        sample into row j of the chunk's buffers."""
        def sub_body(j, st):
            c, b = st
            c = advance(c)
            E, H = c["fields"][:3], c["fields"][3:]
            fe, fh, v, i_ = sample_probes(E, H)
            return (c, dict(
                v=b["v"].at[j].set(v),
                i=b["i"].at[j].set(i_),
                fe=b["fe"].at[j].set(fe),
                fh=b["fh"].at[j].set(fh),
            ))

        return sub_body

    def run(coeffs, waveform, w_port, w_nf, src_ops):
        """Traced run: one device ``while_loop`` over termination chunks.
        Used by vmapped sweeps (a host loop cannot be vmapped)."""
        n_port_freqs = w_port.shape[0]
        n_nf_freqs = w_nf.shape[0]
        waveform = _pad_waveform(waveform)
        step_body = _step_body(coeffs, waveform, src_ops)

        def advance(c):
            return jax.lax.fori_loop(0, decim, step_body, c)

        def chunk_body(carry):
            # n_sub probe samples, each after D pure field steps. Probes
            # are decimated: fields are band-limited to ~f0+fc while dt
            # sits at the Courant limit, so sampling every D steps keeps a
            # >2x Nyquist margin (D chosen in the builder). The openEMS
            # engine samples its DFTs every step — ~50-100x oversampled.
            n0 = carry["n"]
            carry, bufs = jax.lax.fori_loop(
                0, n_sub, _staged_sub_body(advance), (carry, _empty_bufs())
            )
            return _flush_and_check(carry, bufs, n0, w_port, w_nf)

        def cond(carry):
            return (~carry["done"]) & (carry["n"] < np.int32(cfg.n_steps_max))

        carry = jax.lax.while_loop(
            cond, chunk_body, init_carry(coeffs, n_nf_freqs, n_port_freqs))

        return _assemble_output(carry, n_nf_freqs)

    # ------------------------------------------------------------------
    # host-driven chunk pipeline
    # ------------------------------------------------------------------
    # The host dispatches *superchunks*: one donated jit containing K
    # chunks in a fori loop, each `lax.cond`-gated on the carry's `done`
    # flag and containing one flat fori(decim)·n_sub window plus the DFT
    # flush + energy check. The gating makes the semantics identical to
    # the device while_loop — checks every `chunk` steps, compute skipped
    # once converged — with one small host read per superchunk. This
    # structure (flat step loops instead of nested while·fori, and few
    # host dispatches) was chosen from measurements on the accelerator
    # the engine was first built for; whether it beats the traced `run`
    # on the GPU is not measured yet (ROADMAP D3).
    from functools import partial

    def _one_chunk(carry, coeffs, waveform, w_port, w_nf, src_ops):
        """One chunk: n_sub decim-windows + staged probe samples, then
        the DFT flush + energy-decay check (math identical to the traced
        run's chunk body). Called under a per-chunk ``lax.cond`` gate
        (see _get_superchunk), so it runs only while the simulation is
        active."""
        step_body = _step_body(coeffs, waveform, src_ops)

        def advance(c):
            return jax.lax.fori_loop(0, decim, step_body, c)

        if n_sub <= 8:
            # trace-time unroll: no nested-loop carry copies (large grids
            # resolve to small n_sub)
            vs, is_, fes, fhs = [], [], [], []
            for _j in range(n_sub):
                carry = advance(carry)
                E, H = carry["fields"][:3], carry["fields"][3:]
                fe, fh, v, i_ = sample_probes(E, H)
                vs.append(v)
                is_.append(i_)
                fes.append(fe)
                fhs.append(fh)
            bufs = dict(
                v=jnp.stack(vs), i=jnp.stack(is_),
                fe=jnp.stack(fes), fh=jnp.stack(fhs),
            )
        else:
            # large n_sub (small grids / test configs): keep the compact
            # staged fori so the trace stays small
            carry, bufs = jax.lax.fori_loop(
                0, n_sub, _staged_sub_body(advance), (carry, _empty_bufs())
            )

        return _flush_and_check(
            carry, bufs, carry["n"] - np.int32(chunk), w_port, w_nf)

    # superchunk size: up to ~8000 steps (at most 32 chunks) per host
    # dispatch. The chunk loop is a lax.fori (one traced chunk body), so
    # compile time does not grow with K.
    K_sub = max(1, min(n_chunks_max, -(-8000 // chunk), 32))

    _superchunks = {}

    def _get_superchunk(k):
        """Jitted superchunk of exactly ``k`` cond-gated sub-chunks
        (compiled once per distinct k; the trace contains a single chunk
        body)."""
        if k not in _superchunks:
            @partial(jax.jit, donate_argnums=(0,))
            def _superchunk(carry, coeffs, waveform, w_port, w_nf, src_ops):
                def body(_, c):
                    return jax.lax.cond(
                        jnp.logical_and(
                            jnp.logical_not(c["done"]),
                            c["n"] < np.int32(cfg.n_steps_max),
                        ),
                        lambda cc: _one_chunk(
                            cc, coeffs, waveform, w_port, w_nf, src_ops
                        ),
                        lambda cc: cc,
                        c,
                    )

                return jax.lax.fori_loop(0, k, body, carry)

            _superchunks[k] = _superchunk
        return _superchunks[k]

    def host_run(coeffs, waveform, w_port, w_nf, src_ops,
                 resume_state=None, progress_cb=None, abort_cb=None):
        n_port_freqs = int(w_port.shape[0])
        n_nf_freqs = int(w_nf.shape[0])
        waveform = _pad_waveform(jnp.asarray(waveform))
        carry = init_carry(coeffs, n_nf_freqs, n_port_freqs)
        n_cur = 0
        if resume_state is not None:
            resume_state = _rescale_resume_dfts(resume_state, decim)
            n_cur = int(np.asarray(resume_state["n"]))
            carry = dict(carry, **resume_state, done=jnp.bool_(False))
            carry["n"] = jnp.int32(n_cur)
        # dispatch ceil(remaining/K) superchunks of a single compiled
        # size: every chunk inside is cond-gated on both the energy
        # criterion and n < n_steps_max, so overrunning the chunk budget
        # in the last superchunk is a no-op and termination stays
        # step-exact (a tail-sized variant would cost a second compile).
        # Each superchunk boundary pays one small blocking read (the
        # `done` flag) to stop dispatching once converged — the progress
        # callback and abort check ride the same sync point. The
        # reference's Streamlit abort flag could only prevent a run from
        # *starting* (streamlit_app.py:165-168); this one stops a run
        # mid-flight with at most one superchunk (~K·chunk steps) of
        # latency.
        aborted = False
        n_remaining = max(0, n_chunks_max - n_cur // chunk)
        for _ in range(-(-n_remaining // K_sub)):
            carry = _get_superchunk(K_sub)(
                carry, coeffs, waveform, w_port, w_nf, src_ops,
            )
            if bool(carry["done"]):
                break
            if progress_cb is not None or abort_cb is not None:
                steps_done = int(carry["n"])
                if progress_cb is not None:
                    try:
                        progress_cb(steps_done, int(cfg.n_steps_max),
                                    float(carry["e_ratio"]))
                    except Exception:
                        pass  # a broken UI callback must not kill the run
                if abort_cb is not None and abort_cb():
                    aborted = True
                    break

        return dict(_assemble_output(carry, n_nf_freqs), aborted=aborted)

    def lower_superchunk(coeffs, waveform, w_port, w_nf, src_ops):
        carry = init_carry(coeffs, int(w_nf.shape[0]), int(w_port.shape[0]))
        return _get_superchunk(K_sub).lower(
            carry, coeffs, _pad_waveform(jnp.asarray(waveform)), w_port,
            w_nf, src_ops,
        )

    host_run.lower_superchunk = lower_superchunk
    run.host_run = host_run
    run.build_src_ops = build_src_ops
    return run
