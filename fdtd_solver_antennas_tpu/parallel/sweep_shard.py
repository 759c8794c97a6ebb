"""Sweep-level scale-out: shard batched geometry sweeps over devices.

The reference explores designs serially on one machine (SURVEY §2.3 row 4
names cross-host sweep sharding as the framework's scale-out north star
with no reference analog). Here a vmapped sweep (solvers/sweep.py) gains
a device dimension: the batch axis of the stacked coefficient pytrees is
sharded over a ``"sweep"`` mesh axis, so N design variants run
data-parallel — one per device group — inside the same single XLA
program the unsharded sweep uses.

Why this layout: sweep members are *independent* — the hot loop has
zero cross-variant communication, so the ``"sweep"`` axis can span hosts
over the (slow) cross-host network with no bandwidth cost; the only
cross-host traffic is the final result gather (a few KB of DFT
accumulators per variant). Spatial decomposition (1-cell halos every
step — parallel/sharding.py) composes on a second ``"x"`` axis that
should stay *within* a host so halo exchanges ride the fast device
interconnect (NVLink between the GPUs of one host). Fast collectives on
the fast interconnect, embarrassing parallelism on the slow one.

On a multi-host pod slice, initialize ``jax.distributed`` first; the
same entry points then build the sweep axis across all hosts
(``mesh_utils.create_hybrid_device_mesh`` keeps spatial groups
host-local). Single-process virtual meshes (CPU
``--xla_force_host_platform_device_count``) exercise the identical code
path — that is how the tests pin sharded-vs-unsharded equality.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_sweep_mesh(
    n_sweep: Optional[int] = None,
    n_spatial: int = 1,
    devices=None,
) -> Mesh:
    """Device mesh with axes ``("sweep", "x")``.

    ``n_sweep × n_spatial`` must cover the device list; by default all
    devices go on the sweep axis. When more than one process participates
    (multi-host), the hybrid mesh builder keeps the spatial axis packed
    within hosts so halos stay on the in-host interconnect and only the
    sweep axis spans hosts.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_sweep is None:
        n_sweep = len(devices) // n_spatial
    if n_sweep * n_spatial != len(devices):
        raise ValueError(
            f"mesh {n_sweep}×{n_spatial} != {len(devices)} devices"
        )
    if jax.process_count() > 1:  # pragma: no cover — needs a real pod
        from jax.experimental import mesh_utils

        if n_sweep % jax.process_count():
            raise ValueError(
                f"sweep axis {n_sweep} must divide evenly over "
                f"{jax.process_count()} processes"
            )
        arr = mesh_utils.create_hybrid_device_mesh(
            (n_sweep // jax.process_count(), n_spatial),
            (jax.process_count(), 1),
            devices=devices,
        )
        return Mesh(arr, axis_names=("sweep", "x"))
    arr = np.array(devices).reshape(n_sweep, n_spatial)
    return Mesh(arr, axis_names=("sweep", "x"))


def _batch_spec(mesh: Mesh, shape: Tuple[int, ...]) -> P:
    """PartitionSpec for a (B, …) batched array: batch over 'sweep', and
    for (B, Px, Py, Pz) coefficient stacks also Px over 'x' when the mesh
    has a spatial extent that divides Px (device_put requires exact
    divisibility; sweep grids aren't padded, so fall back to pure
    data-parallel otherwise — still correct, just unsharded spatially)."""
    spatial = mesh.devices.shape[1]
    if len(shape) == 4 and spatial > 1 and shape[1] % spatial == 0:
        return P("sweep", "x", None, None)
    return P("sweep") if len(shape) >= 1 else P()


def pad_batch(n: int, n_sweep: int) -> Tuple[int, int]:
    """(padded_B, pad) so the batch divides the sweep axis. Padded slots
    replay the last variant and are trimmed from results."""
    padded = int(math.ceil(n / n_sweep)) * n_sweep
    return padded, padded - n


def shard_sweep(prepared, mesh: Mesh):
    """Shard a ``SweepPrepared`` over ``mesh`` in place.

    The batched coefficient stacks are placed with the sweep (and
    optionally spatial) sharding; the already-jitted vmapped run then
    executes SPMD — no code change, the partitioner sees sharded inputs
    and keeps every per-variant carry local to its device group. Batches
    that do not divide the sweep axis are padded by repeating the last
    variant; the ``run_*`` post-processing indexes only the real variants
    (it never reads the padded rows), so no explicit trim is required.
    """
    if prepared.batched_coeffs is None:
        raise ValueError("prepare a sweep before sharding it")
    n_sweep = mesh.devices.shape[0]
    b = len(prepared.variants)
    padded, pad = pad_batch(b, n_sweep)
    coeffs = prepared.batched_coeffs
    if pad:
        coeffs = {
            k: jnp.concatenate(
                [v] + [v[-1:]] * pad, axis=0
            ) for k, v in coeffs.items()
        }
    prepared.batched_coeffs = {
        k: jax.device_put(v, NamedSharding(mesh, _batch_spec(mesh, v.shape)))
        for k, v in coeffs.items()
    }
    prepared._sweep_pad = pad
    prepared._sweep_mesh = mesh
    return prepared


def trim_sweep_out(prepared, out):
    """Optional utility: drop padded batch rows from a sharded sweep's
    raw output pytree (device-side slicing — nothing is materialized to
    host; the big field arrays stay on device). The stock ``run_*``
    post-processing never reads padded rows, so calling this is only
    needed when consuming ``out`` directly."""
    pad = getattr(prepared, "_sweep_pad", 0)
    if not pad:
        return out
    b = len(prepared.variants)

    def _trim(a):
        return (
            a[:b]
            if getattr(a, "ndim", 0) >= 1 and a.shape[0] == b + pad
            else a
        )

    return jax.tree_util.tree_map(_trim, out)
