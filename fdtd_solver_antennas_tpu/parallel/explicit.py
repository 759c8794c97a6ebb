"""Explicit-collective multi-chip FDTD: ``shard_map`` + ``ppermute`` halos.

The GSPMD path (:mod:`.sharding`) annotates arrays and lets XLA's SPMD
partitioner insert halo exchanges. This module is the hand-scheduled
alternative: the Yee grid is decomposed along x over a 1-D device mesh and
the whole chunked time loop runs inside one ``shard_map``, with

- one ``ppermute`` of the stacked (Ey, Ez) boundary plane per H half-step
  (each device needs its +x neighbor's first row) and one of (Hy, Hz) per
  E half-step (−x neighbor's last row) — 2 plane exchanges per leapfrog
  step over the device interconnect;
- the cyclic wrap rows masked by the zero-coefficient invariant (inverse
  spacings and boundary-plane cb are zero where wrapped data lands);
- probe extraction as per-device *partial* gathers (weights zeroed for
  rows a device does not own) accumulated into local DFT sums — DFT
  linearity means one ``psum`` of the accumulators at the very end of the
  run replaces any per-sample collective;
- the energy-decay termination test as the only per-chunk collective
  (one scalar ``psum``).

Collective traffic per step is therefore 2 planes × 2 fields × 4 B ≈
``16·Py·Pz`` bytes per device. MUR x-face updates are applied as masked
row-selects; a top face on a shard boundary fetches its inward neighbor
via an extra per-step halo (``straddle_top``). y/z faces are
device-local. CPML is supported — the ψ recursions are elementwise given
the halo-extended derivative terms.

The reference has no distributed execution at all (SURVEY §2.3); this is
the framework's scale-out path for grids beyond one device's memory.
"""

from __future__ import annotations

import math
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..physics import MU0
from ..ops.fdtd import (
    PSI_KEYS,
    _bdiff,
    _bvec,
    _fdiff,
    _plane,
    _set_plane,
    build_probe_gathers,
    build_src_mats,
    dft_flush,
    n_probe_rows,
    nf_to_complex,
)


def _dedup_asarray(arrs):
    """Upload each distinct host array once (a fresh start passes the same
    zero array for every resume field)."""
    seen: dict = {}
    return [seen.setdefault(id(a), jnp.asarray(a)) for a in arrs]


def _localize_gathers(idx, w, Px, Py, Pz, n_dev):
    """Global flat gather (idx, w) → per-device local (n_dev, …) arrays.

    Entries a device does not own get index 0 and weight 0, so each
    device's gather-sum is a partial sum and the full probe value is the
    ``psum`` over devices (applied once to the DFT accumulators).
    """
    n = Px // n_dev
    plane = Py * Pz
    comp = idx // (Px * plane)
    rem = idx % (Px * plane)
    i = rem // plane
    jk = rem % plane
    owner = i // n
    local = (comp * n + (i % n)) * plane + jk
    idx_d = np.zeros((n_dev,) + idx.shape, np.int32)
    w_d = np.zeros((n_dev,) + w.shape, np.float32)
    for d in range(n_dev):
        own = owner == d
        idx_d[d] = np.where(own, local, 0)
        w_d[d] = np.where(own, w, 0.0)
    return idx_d, w_d


def build_explicit_run(sim, mesh: Mesh, axis_name: str | None = None):
    """Build a jitted explicit-collective run function for ``sim``.

    ``mesh`` must be 1-D (n_dev devices); the padded x extent must be
    divisible by n_dev. Returns ``run(resume_state=None)`` producing the
    same output dict as ``PreparedSimulation.run()``, including a
    canonical ``state`` checkpoint portable across all run paths. Each
    device advances its x-slab with the XLA leapfrog step below,
    exchanging one plane halo per half-step.
    """
    axis_name = axis_name or mesh.axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    grid = sim.grid
    Px, Py, Pz = sim.padded_shape or grid.shape
    if Px % n_dev:
        raise ValueError(
            f"padded x extent {Px} not divisible by {n_dev} devices; "
            "build the simulation with pad_multiple=(n_dev, 1, 1)"
        )
    n = Px // n_dev
    Qx, Qy, Qz = grid.shape
    if n < 2:
        raise ValueError(f"need ≥ 2 rows per shard (Qx={Qx}, shard={n})")

    # When the top MUR face row (Qx−1) sits on a shard boundary its inward
    # neighbor (Qx−2) lives on the previous device — fetch it via an extra
    # per-step halo instead of an in-device roll.
    straddle_top = (Qx - 1) % n == 0
    cfg = sim.cfg
    dt = sim.dt
    dtmu = np.float32(dt / MU0)
    mur = cfg.boundary.upper().startswith("MUR")
    inv_p, inv_d, mur_coef, pml = sim._aux
    n_ports = n_probe_rows(sim)
    n_src_steps = sim.n_source_steps
    decim = int(sim.probe_decim)
    n_sub = max(1, int(cfg.check_every) // decim)
    chunk = n_sub * decim
    n_chunks_max = int(math.ceil(cfg.n_steps_max / chunk))
    n_nf = len(sim.nf_freqs_hz)
    n_pf = len(sim.port_freqs_hz)

    # ---- static operands --------------------------------------------------
    # replicated broadcast vectors (y, z) and sharded column vectors (x)
    iy_p, iz_p = _bvec(inv_p[1], 1), _bvec(inv_p[2], 2)
    iy_d, iz_d = _bvec(inv_d[1], 1), _bvec(inv_d[2], 2)
    ix_p_g = np.asarray(inv_p[0], np.float32).reshape(Px, 1, 1)
    ix_d_g = np.asarray(inv_d[0], np.float32).reshape(Px, 1, 1)

    # MUR x-face one-hot row masks (global, sharded along x)
    m_x0 = np.zeros((Px, 1, 1), np.float32)
    m_x0[0] = 1.0
    m_xt = np.zeros((Px, 1, 1), np.float32)
    m_xt[Qx - 1] = 1.0

    # per-component source matrices (global, sharded along x)
    src_np = build_src_mats(sim, Px, Py, Pz)
    src_comps = sorted(src_np)
    src_mats_g = [src_np[c] for c in src_comps]

    # probe gathers, localized per device
    (pg_e_idx, pg_e_w, pg_h_idx, pg_h_w, face_layout, T_faces,
     pv_idx, pv_w, pi_idx, pi_w) = build_probe_gathers(sim, Px, Py, Pz)
    loc = lambda i, w: _localize_gathers(i, w, Px, Py, Pz, n_dev)
    pg_e_idx_d, pg_e_w_d = loc(pg_e_idx, pg_e_w)
    pg_h_idx_d, pg_h_w_d = loc(pg_h_idx, pg_h_w)
    pv_idx_d, pv_w_d = loc(pv_idx, pv_w)
    pi_idx_d, pi_w_d = loc(pi_idx, pi_w)

    # CPML profiles: x-graded are sharded columns, y/z replicated rows
    if pml is not None:
        bh = {a: _bvec(pml[a]["half"][0], a) for a in (1, 2)}
        ch = {a: _bvec(pml[a]["half"][1], a) for a in (1, 2)}
        be = {a: _bvec(pml[a]["node"][0], a) for a in (1, 2)}
        ce = {a: _bvec(pml[a]["node"][1], a) for a in (1, 2)}
        pml_x_g = np.stack([
            np.asarray(pml[0]["half"][0], np.float32),
            np.asarray(pml[0]["half"][1], np.float32),
            np.asarray(pml[0]["node"][0], np.float32),
            np.asarray(pml[0]["node"][1], np.float32),
        ], axis=1).reshape(Px, 4, 1, 1)
    else:
        pml_x_g = np.zeros((Px, 0, 1, 1), np.float32)

    mur_c = {k: np.float32(v) for k, v in mur_coef.items()}
    perm_from_next = [(d, (d - 1) % n_dev) for d in range(n_dev)]
    perm_from_prev = [(d, (d + 1) % n_dev) for d in range(n_dev)]

    def local_fn(coeffs, waveform, w_port, w_nf, ixp, ixd, m0, mt,
                 src_list, pml_x, ge_i, ge_w, gh_i, gh_w,
                 v_i, v_w, i_i, i_w,
                 res_f, res_psi, res_n, res_emax):
        # shard_map hands (1, T, k)-blocks of the per-device gather tables
        ge_i, ge_w = ge_i[0], ge_w[0]
        gh_i, gh_w = gh_i[0], gh_w[0]
        v_i, v_w = v_i[0], v_w[0]
        i_i, i_w = i_i[0], i_w[0]
        if pml is not None:
            bh_x = pml_x[:, 0]
            ch_x = pml_x[:, 1]
            be_x = pml_x[:, 2]
            ce_x = pml_x[:, 3]

        def halo_from_next(arrs):
            """Receive each array's first row from the +x neighbor."""
            stacked = jnp.stack([a[0:1] for a in arrs])
            got = jax.lax.ppermute(stacked, axis_name, perm_from_next)
            return [got[i] for i in range(len(arrs))]

        def halo_from_prev(arrs):
            stacked = jnp.stack([a[-1:] for a in arrs])
            got = jax.lax.ppermute(stacked, axis_name, perm_from_prev)
            return [got[i] for i in range(len(arrs))]

        def fdiff_x(a, nxt):
            return jnp.concatenate([a[1:], nxt], 0) - a

        def bdiff_x(a, prv):
            return a - jnp.concatenate([prv, a[:-1]], 0)

        def h_update(E, H, psi_h):
            Ex, Ey, Ez = E
            Hx, Hy, Hz = H
            ey_n, ez_n = halo_from_next([Ey, Ez])
            dEz_y = _fdiff(Ez, 1) * iy_p
            dEy_z = _fdiff(Ey, 2) * iz_p
            dEx_z = _fdiff(Ex, 2) * iz_p
            dEz_x = fdiff_x(Ez, ez_n) * ixp
            dEy_x = fdiff_x(Ey, ey_n) * ixp
            dEx_y = _fdiff(Ex, 1) * iy_p
            if pml is not None:
                psi_h = dict(
                    xy=bh[1] * psi_h["xy"] + ch[1] * dEz_y,
                    xz=bh[2] * psi_h["xz"] + ch[2] * dEy_z,
                    yz=bh[2] * psi_h["yz"] + ch[2] * dEx_z,
                    yx=bh_x * psi_h["yx"] + ch_x * dEz_x,
                    zx=bh_x * psi_h["zx"] + ch_x * dEy_x,
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

        def e_update(E, H, s_val, psi_e):
            Ex, Ey, Ez = E
            Hx, Hy, Hz = H
            hy_p, hz_p = halo_from_prev([Hy, Hz])
            dHz_y = _bdiff(Hz, 1) * iy_d
            dHy_z = _bdiff(Hy, 2) * iz_d
            dHx_z = _bdiff(Hx, 2) * iz_d
            dHz_x = bdiff_x(Hz, hz_p) * ixd
            dHy_x = bdiff_x(Hy, hy_p) * ixd
            dHx_y = _bdiff(Hx, 1) * iy_d
            if pml is not None:
                psi_e = dict(
                    xy=be[1] * psi_e["xy"] + ce[1] * dHz_y,
                    xz=be[2] * psi_e["xz"] + ce[2] * dHy_z,
                    yz=be[2] * psi_e["yz"] + ce[2] * dHx_z,
                    yx=be_x * psi_e["yx"] + ce_x * dHz_x,
                    zx=be_x * psi_e["zx"] + ce_x * dHy_x,
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
            for ci, comp in enumerate(src_comps):
                En[comp] = En[comp] + src_list[ci] * s_val
            if mur:
                Eo = [Ex, Ey, Ez]
                # x faces as masked row-selects. Rows 0/1 are device-local
                # (shard ≥ 2 rows) so the low fix uses an in-device roll;
                # roll wraps at other device edges land on masked-out rows.
                # The top fix needs row Qx−2 — an extra halo when Qx−1
                # sits on a shard boundary, an in-device roll otherwise.
                c0, c1 = mur_c[(0, 0)], mur_c[(0, 1)]
                if straddle_top:
                    eo1_p, eo2_p, en1_p, en2_p = halo_from_prev(
                        [Eo[1], Eo[2], En[1], En[2]]
                    )
                    prev_rows = {1: (eo1_p, en1_p), 2: (eo2_p, en2_p)}
                for comp in (1, 2):
                    fix0 = jnp.roll(Eo[comp], -1, 0) + c0 * (
                        jnp.roll(En[comp], -1, 0) - Eo[comp]
                    )
                    if straddle_top:
                        eo_p, en_p = prev_rows[comp]
                        eo_dn = jnp.concatenate([eo_p, Eo[comp][:-1]], 0)
                        en_dn = jnp.concatenate([en_p, En[comp][:-1]], 0)
                    else:
                        eo_dn = jnp.roll(Eo[comp], 1, 0)
                        en_dn = jnp.roll(En[comp], 1, 0)
                    fixt = eo_dn + c1 * (en_dn - Eo[comp])
                    En[comp] = (
                        En[comp] * (1.0 - m0 - mt) + m0 * fix0 + mt * fixt
                    )
                # y and z faces are unsharded: same plane writes as the
                # single-chip XLA path, in the same x→y→z order
                for b_axis in (1, 2):
                    for side, (idx, nb) in enumerate(
                        ((0, 1),
                         (grid.shape[b_axis] - 1, grid.shape[b_axis] - 2))
                    ):
                        c = mur_c[(b_axis, side)]
                        for comp in range(3):
                            if comp == b_axis:
                                continue
                            new = _plane(Eo[comp], b_axis, nb) + c * (
                                _plane(En[comp], b_axis, nb)
                                - _plane(Eo[comp], b_axis, idx)
                            )
                            En[comp] = _set_plane(En[comp], b_axis, idx, new)
            return tuple(En), psi_e

        def sample_probes(E, H):
            Ecat = jnp.stack(E).reshape(-1)
            Hcat = jnp.stack(H).reshape(-1)
            fe = (Ecat[ge_i] * ge_w).sum(-1)
            fh = (Hcat[gh_i] * gh_w).sum(-1)
            v = (Ecat[v_i] * v_w).sum(-1)
            i_ = (Hcat[i_i] * i_w).sum(-1)
            return fe, fh, v, i_

        # ---- chunked while loop (mirrors ops.fdtd._make_run_fn) ----------
        wf_len = n_chunks_max * chunk
        if waveform.shape[0] < wf_len:
            waveform = jnp.concatenate(
                [waveform,
                 jnp.zeros((wf_len - waveform.shape[0],), waveform.dtype)]
            )

        # the (Px, Py, Pz) resume arrays shard along x → (n, Py, Pz)
        carry = dict(
            fields=tuple(res_f),
            # DFT accumulators stay zero per device even on resume: they
            # are *partial* sums finalized by one psum, so the resumed
            # totals are added once on the host after the run (linearity)
            uf=jnp.zeros((2, n_ports, n_pf), jnp.float32),
            if_=jnp.zeros((2, n_ports, n_pf), jnp.float32),
            nf_e=jnp.zeros((2, n_nf, T_faces), jnp.float32),
            nf_h=jnp.zeros((2, n_nf, T_faces), jnp.float32),
            psi_e=dict(zip(PSI_KEYS, res_psi[:6])) if pml is not None else {},
            psi_h=dict(zip(PSI_KEYS, res_psi[6:])) if pml is not None else {},
            n=res_n.astype(jnp.int32),
            e_max=res_emax.astype(jnp.float32),
            e_ratio=jnp.float32(1.0),
            done=jnp.bool_(False),
        )

        def chunk_body(carry):
            bufs = dict(
                v=jnp.zeros((n_sub, n_ports), jnp.float32),
                i=jnp.zeros((n_sub, n_ports), jnp.float32),
                fe=jnp.zeros((n_sub, T_faces), jnp.float32),
                fh=jnp.zeros((n_sub, T_faces), jnp.float32),
            )

            def step_only(_, c):
                E = c["fields"][:3]
                H = c["fields"][3:]
                Hn, psi_h = h_update(E, H, c["psi_h"])
                En, psi_e = e_update(E, Hn, waveform[c["n"]], c["psi_e"])
                return dict(c, fields=tuple(En) + tuple(Hn),
                            psi_e=psi_e, psi_h=psi_h, n=c["n"] + 1)

            def sub_body(j, st):
                c, b = st
                c = jax.lax.fori_loop(0, decim, step_only, c)
                E, H = c["fields"][:3], c["fields"][3:]
                fe, fh, v, i_ = sample_probes(E, H)
                b = dict(
                    v=b["v"].at[j].set(v),
                    i=b["i"].at[j].set(i_),
                    fe=b["fe"].at[j].set(fe),
                    fh=b["fh"].at[j].set(fh),
                )
                return (c, b)

            n0 = carry["n"]
            carry, bufs = jax.lax.fori_loop(0, n_sub, sub_body, (carry, bufs))

            carry = dict(carry, **dft_flush(
                carry, bufs, n0, w_port, w_nf, n_sub, decim, dt))

            # energy termination: the only per-chunk collective (1 scalar)
            E = carry["fields"][:3]
            energy = jax.lax.psum(sum(jnp.sum(e * e) for e in E), axis_name)
            e_max = jnp.maximum(carry["e_max"], energy)
            ratio = jnp.where(e_max > 0, energy / e_max, jnp.float32(1.0))
            done = (ratio < np.float32(cfg.end_criteria)) & (
                carry["n"] > np.int32(n_src_steps)
            )
            return dict(carry, e_max=e_max, e_ratio=ratio, done=done)

        def cond(carry):
            return (~carry["done"]) & (carry["n"] < np.int32(cfg.n_steps_max))

        carry = jax.lax.while_loop(cond, chunk_body, carry)

        # one psum finalizes every partial DFT accumulator (linearity)
        uf = jax.lax.psum(carry["uf"], axis_name)
        if_ = jax.lax.psum(carry["if_"], axis_name)
        nf_e = jax.lax.psum(carry["nf_e"], axis_name)
        nf_h = jax.lax.psum(carry["nf_h"], axis_name)
        out_fields = tuple(carry["fields"])
        psi_state = ()
        if pml is not None:
            psi_state = tuple(carry["psi_e"][k] for k in PSI_KEYS) + tuple(
                carry["psi_h"][k] for k in PSI_KEYS)
        return (out_fields, psi_state, uf, if_, nf_e, nf_h,
                carry["n"], carry["e_max"], carry["e_ratio"])

    # ---- shard_map wrapping ------------------------------------------------
    px = P(axis_name, None, None)
    gspec = P(axis_name, None, None)  # (n_dev, T, k) gather tables
    n_psi_args = 12 if pml is not None else 0
    in_specs = (
        {k: px for k in sim.coeffs},     # coeffs
        P(None),                          # waveform
        P(None),                          # w_port
        P(None),                          # w_nf
        px, px, px, px,                   # ixp, ixd, m0, mt
        [px] * len(src_mats_g),           # source matrices
        P(axis_name, None, None, None),   # pml_x (Px, 4|0, 1, 1)
        gspec, gspec, gspec, gspec,       # face gathers e/h
        gspec, gspec, gspec, gspec,       # port gathers v/i
        [px] * 6,                         # resume fields (zeros if fresh)
        [px] * n_psi_args,                # resume ψ
        P(), P(),                         # resume n, e_max
    )
    out_specs = (
        (px,) * 6,                        # fields stay sharded
        (px,) * n_psi_args,               # ψ state (owned 3D rows)
        P(None, None, None),              # uf (replicated after psum)
        P(None, None, None),              # if_
        P(None, None, None),              # nf_e
        P(None, None, None),              # nf_h
        P(),                              # steps
        P(),                              # e_max
        P(),                              # e_ratio
    )
    mapped = jax.shard_map(
        local_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    run_jit = jax.jit(mapped)

    def _build_args(resume_state=None):
        """Operand tuple for ``run_jit`` plus the resumed DFT totals
        (None for a fresh start) — shared by ``run`` and ``lowered``."""
        if resume_state is not None:
            rs = sim._adapt_resume_arrays(dict(resume_state))
            r_fields = [np.asarray(f, np.float32) for f in rs["fields"]]
            r_psi = (
                [np.asarray(rs["psi_e"][k], np.float32) for k in PSI_KEYS]
                + [np.asarray(rs["psi_h"][k], np.float32)
                   for k in PSI_KEYS]
            ) if pml is not None else []
            # cadence rescale: the resumed sums were accumulated at the
            # checkpoint's probe decimation; post-processing multiplies
            # the combined totals by THIS run's dft_dt (see
            # ops.fdtd._rescale_resume_dfts for the derivation)
            old_decim = int(np.asarray(rs.get("decim", decim)))
            dscale = np.float32(old_decim / decim)
            r_uf = np.asarray(rs["uf"], np.float32) * dscale
            r_if = np.asarray(rs["if_"], np.float32) * dscale
            r_nfe = np.asarray(rs["nf_e"], np.float32) * dscale
            r_nfh = np.asarray(rs["nf_h"], np.float32) * dscale
            r_n, r_emax = np.int32(rs["n"]), np.float32(rs["e_max"])
        else:
            z3 = np.zeros((Px, Py, Pz), np.float32)
            r_fields = [z3] * 6
            r_psi = [z3] * 12 if pml is not None else []
            r_uf = r_if = r_nfe = r_nfh = None
            r_n, r_emax = np.int32(0), np.float32(0.0)
        args = (
            sim.coeffs,
            jnp.asarray(sim.waveform),
            jnp.asarray(2 * np.pi * sim.port_freqs_hz, jnp.float32),
            jnp.asarray(2 * np.pi * sim.nf_freqs_hz, jnp.float32),
            jnp.asarray(ix_p_g), jnp.asarray(ix_d_g),
            jnp.asarray(m_x0), jnp.asarray(m_xt),
            [jnp.asarray(s) for s in src_mats_g],
            jnp.asarray(pml_x_g),
            jnp.asarray(pg_e_idx_d), jnp.asarray(pg_e_w_d),
            jnp.asarray(pg_h_idx_d), jnp.asarray(pg_h_w_d),
            jnp.asarray(pv_idx_d), jnp.asarray(pv_w_d),
            jnp.asarray(pi_idx_d), jnp.asarray(pi_w_d),
            _dedup_asarray(r_fields),
            _dedup_asarray(r_psi),
            jnp.asarray(r_n), jnp.asarray(r_emax),
        )
        resumed = (
            (r_uf, r_if, r_nfe, r_nfh) if resume_state is not None else None
        )
        return args, resumed

    def run(resume_state=None):
        """Execute (or resume) the sharded run.

        ``resume_state`` is the canonical ``out["state"]`` pytree of any
        previous run — single-device or sharded, any padding (``sim._adapt_resume_arrays`` re-pads) — and the output
        carries a ``state`` entry in the same canonical 3D layout, so
        checkpoints are portable across all run paths (SURVEY §5
        checkpoint/resume, extended to multi-chip)."""
        args, resumed = _build_args(resume_state)
        (fields, psi_state, uf, if_, nf_e, nf_h, steps, e_max,
         e_ratio) = run_jit(*args)
        jax.block_until_ready(steps)

        # resumed DFT totals are added once, after the final psum
        uf_s = np.asarray(uf)
        if_s = np.asarray(if_)
        nfe_s = np.asarray(nf_e)
        nfh_s = np.asarray(nf_h)
        if resumed is not None:
            r_uf, r_if, r_nfe, r_nfh = resumed
            uf_s = uf_s + r_uf
            if_s = if_s + r_if
            nfe_s = nfe_s + r_nfe
            nfh_s = nfh_s + r_nfh

        def split_faces(acc):
            return [
                acc[:, :, off : off + 2 * nu * nv].reshape(2, n_nf, 2, nu, nv)
                for (off, nu, nv) in face_layout
            ]

        state = dict(
            fields=tuple(np.asarray(f) for f in fields),
            psi_e={k: np.asarray(psi_state[i])
                   for i, k in enumerate(PSI_KEYS)} if pml is not None
            else {},
            psi_h={k: np.asarray(psi_state[6 + i])
                   for i, k in enumerate(PSI_KEYS)} if pml is not None
            else {},
            uf=uf_s, if_=if_s, nf_e=nfe_s, nf_h=nfh_s,
            n=np.asarray(steps), e_max=np.asarray(e_max),
            e_ratio=np.asarray(e_ratio), decim=np.int32(decim),
        )
        return dict(
            uf=nf_to_complex(uf_s),
            if_=nf_to_complex(if_s),
            nf_e=split_faces(nfe_s),
            nf_h=split_faces(nfh_s),
            steps=steps,
            e_ratio=e_ratio,
            fields=fields,
            state=state,
        )

    def lowered(resume_state=None):
        """Lower (without executing) the jitted sharded run — lets tests
        compile the program and inspect its HLO, e.g. the
        collective-count guard in tests/test_sharding.py that pins the
        two-plane-halos-per-step structure."""
        args, _ = _build_args(resume_state)
        return run_jit.lower(*args)

    run.lowered = lowered
    return run
