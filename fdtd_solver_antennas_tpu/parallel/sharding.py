"""Multi-chip spatial decomposition via ``jax.sharding`` (GSPMD).

The reference has no distributed execution at all (SURVEY §2.3); its C++
engine threads internally. The scale-out analog here is *spatial
sharding of the Yee grid*: fields and coefficient arrays are annotated with
a ``NamedSharding`` over a device mesh and the exact same step function is
jitted — XLA's SPMD partitioner turns the stencil's shifted slices into
1-cell halo exchanges (collective-permutes over the device interconnect) and the energy/DFT
reductions into ``psum``s automatically. This is the scaling-book recipe:
pick a mesh, annotate shardings, let XLA insert collectives.

Grids that exceed one chip's HBM shard along x (and optionally y); sweeps
batch along a separate data axis with ``vmap`` + sharding instead.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_device_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("x",),
    devices=None,
) -> Mesh:
    """Create a device mesh for spatial decomposition.

    ``shape`` defaults to all available devices along the first axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def field_partition_spec(mesh: Mesh) -> P:
    """PartitionSpec for (Px, Py, Pz) field/coefficient arrays: shard x
    (and y if the mesh has a second axis), keep z (the lane axis) local."""
    names = mesh.axis_names
    if len(names) >= 2 and mesh.devices.shape[1] > 1:
        return P(names[0], names[1], None)
    return P(names[0], None, None)


def shard_fields(arrays, mesh: Mesh):
    """Place (Px, Py, Pz) arrays onto the mesh with the spatial spec."""
    spec = field_partition_spec(mesh)
    sharding = NamedSharding(mesh, spec)
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sharding) if getattr(a, "ndim", 0) == 3 else a,
        arrays,
    )


def shard_simulation(sim, mesh: Mesh):
    """Shard a ``PreparedSimulation`` over ``mesh`` in place.

    Coefficient arrays are resharded, and the run function is rebuilt so the
    field-state zeros carry a sharding constraint — from then on every step
    executes SPMD with XLA-inserted halo exchanges.
    """
    from ..ops.fdtd import rebuild_run_fn

    sharding = NamedSharding(mesh, field_partition_spec(mesh))
    sim.coeffs = {
        k: jax.device_put(v, sharding) if v.ndim == 3 else v
        for k, v in sim.coeffs.items()
    }
    sim.field_sharding = sharding
    rebuild_run_fn(sim)
    return sim


def sharded_step_fn(sim, mesh: Mesh):
    """Return a jitted one-step function over sharded fields.

    Used by the multi-chip dry run: builds zero fields with the mesh
    sharding and advances one leapfrog step (H then E with MUR + port
    source), exercising the halo-exchange pattern end to end.
    """
    shard_simulation(sim, mesh)
    return sim
