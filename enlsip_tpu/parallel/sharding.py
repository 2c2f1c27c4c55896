"""Mesh sharding of batched solves across devices and hosts.

SURVEY.md §5.8: the reference has no communication layer; this design
shards the *batch* axis of independent CNLS instances over a 1-D
``jax.sharding.Mesh``.  Each device solves its own lanes to
convergence (``shard_map``); results are gathered only on exit.

Multi-host use: call ``jax.distributed.initialize()`` first, build the
mesh over ``jax.devices()``, and feed a process-local shard of the
batch through ``jax.make_array_from_process_local_data``.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.driver import Functions
from ..core.types import Dims, Options, Tols, matmul_precision_scope
from .batch import BatchResult, finalize, init_batch, run_batch


def batch_mesh(devices: Sequence[jax.Device] | None = None,
               axis: str = "batch") -> Mesh:
    """1-D device mesh over the batch axis (all visible devices by
    default — spanning hosts when jax.distributed is initialized)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis,))


@partial(jax.jit, static_argnames=("fns", "dims", "opts", "dtype_name",
                                   "check_every", "mesh", "axis"))
def _run_sharded_jit(x0, data, rdims, fns, dims, opts, tols, dtype_name,
                     check_every=1, mesh=None, axis="batch"):
    """Shared jitted body: each device runs the whole batched solve on
    its own lanes (``shard_map`` over the batch axis).  Lanes are
    independent, so no collective runs inside the loop, and the fused
    kernels only ever see device-local operands."""
    def local(x0, data, rdims, tols):
        carry = init_batch(fns, x0, dims, opts, jnp.dtype(dtype_name), data,
                           rdims)
        carry = run_batch(carry, fns, dims, opts, tols, data=data,
                          rdims=rdims, check_every=check_every)
        return finalize(carry)

    lanes = P(axis)
    return jax.shard_map(local, mesh=mesh,
                         in_specs=(lanes, lanes, lanes, P()),
                         out_specs=lanes, check_vma=False)(x0, data, rdims,
                                                           tols)


def solve_batched_sharded(fns: Functions, x0_batch, dims: Dims,
                          opts: Options, tols: Tols, mesh: Mesh | None = None,
                          axis: str = "batch", dtype=None,
                          data=None, rdims=None) -> BatchResult:
    """Batched solve with the batch dimension sharded over ``mesh``.

    The batch size must divide evenly over the mesh (pad with copies of
    any row and drop the tail if needed — converged duplicates cost one
    frozen lane each).  ``data``: optional per-lane data pytree as in
    :func:`solve_batched`; its leaves are sharded over the same axis.
    """
    mesh = mesh or batch_mesh()
    x0_batch = jnp.asarray(x0_batch)
    dtype = dtype or x0_batch.dtype
    B = x0_batch.shape[0]
    n_dev = mesh.devices.size
    pad = (n_dev - B % n_dev) % n_dev

    def pad_lanes(a):
        if pad == 0:
            return a
        return jnp.concatenate(
            [a, jnp.broadcast_to(a[-1:], (pad,) + a.shape[1:])])

    sharding = NamedSharding(mesh, P(axis))
    x0_batch = jax.device_put(pad_lanes(x0_batch.astype(dtype)), sharding)
    data = () if data is None else jax.tree.map(
        lambda a: jax.device_put(pad_lanes(jnp.asarray(a)), sharding), data)
    rdims = None if rdims is None else jax.tree.map(
        lambda a: jax.device_put(pad_lanes(jnp.asarray(a)), sharding), rdims)

    with matmul_precision_scope(opts):
        res = _run_sharded_jit(x0_batch, data, rdims, fns, dims, opts, tols,
                               jnp.dtype(dtype).name, mesh=mesh, axis=axis)
    if res.x.shape[0] != B:  # drop padding
        res = BatchResult(exit_code=res.exit_code[:B], x=res.x[:B],
                          f=res.f[:B], n_iter=res.n_iter[:B],
                          counters=jax.tree.map(lambda a: a[:B], res.counters))
    return res


def global_from_process_local(mesh: Mesh, pytree, axis: str = "batch"):
    """Assemble global arrays sharded over ``axis`` from per-process
    shards (each leaf: this process's lanes, in lane order).

    Multi-host entry (SURVEY §5.8 — no reference counterpart): every
    process contributes only the lanes its local devices own; the global
    lane order follows the mesh's device order (process-major for a mesh
    built from ``jax.devices()``)."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(
        lambda a: jax.make_array_from_process_local_data(
            sharding, np.asarray(a)), pytree)


def local_lanes(array) -> np.ndarray:
    """This process's lanes of a batch-sharded global array, in global
    lane order (inverse of :func:`global_from_process_local`)."""
    shards = sorted(array.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards])


def solve_batched_sharded_mp(fns: Functions, x0_local, dims: Dims,
                             opts: Options, tols: Tols,
                             mesh: Mesh | None = None, axis: str = "batch",
                             dtype=None, data_local=None,
                             rdims_local=None,
                             check_every: int = 1) -> BatchResult:
    """Multi-process batched solve: each process passes ITS OWN lanes.

    Call ``jax.distributed.initialize`` first; the mesh spans all
    processes' devices.  ``x0_local`` (B_local, n) and the optional
    ``data_local``/``rdims_local`` leaves hold this process's lanes;
    B_local must divide evenly over the local device count.  Returns a
    BatchResult of GLOBAL arrays — use :func:`local_lanes` on its leaves
    to read back this process's results.

    Each device loops until its own lanes have terminated, so the
    processes exchange data only to assemble the global result."""
    mesh = mesh or batch_mesh()
    x0_local = np.asarray(x0_local)
    dtype = dtype or x0_local.dtype
    n_local = len([d for d in mesh.devices.flat
                   if d.process_index == jax.process_index()])
    if n_local == 0 or x0_local.shape[0] % n_local:
        raise ValueError(
            f"B_local={x0_local.shape[0]} must divide evenly over the "
            f"{n_local} local devices in the mesh")
    x0 = global_from_process_local(
        mesh, x0_local.astype(dtype), axis)
    data = () if data_local is None else global_from_process_local(
        mesh, jax.tree.map(np.asarray, data_local), axis)
    rdims = None if rdims_local is None else global_from_process_local(
        mesh, jax.tree.map(np.asarray, rdims_local), axis)
    with matmul_precision_scope(opts):
        return _run_sharded_jit(x0, data, rdims, fns, dims, opts, tols,
                                jnp.dtype(dtype).name,
                                check_every=check_every, mesh=mesh,
                                axis=axis)
