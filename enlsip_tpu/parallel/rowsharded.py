"""Giant-m problems: residual rows sharded across the mesh.

SURVEY.md §5.7: the analogue of sequence parallelism for this
framework partitions the long axis — the m residual rows of ``rx`` and
``J`` (and everything derived from them: the J2 buffer, its reflectors
``V``, the ``d`` vector) — across devices, keeping the small n-space
core replicated.  Rather than hand-writing the collectives, the solver
states the sharding and XLA/GSPMD partitions the whole jitted
iteration: row-block GEMVs become local GEMV + ``psum``, column norms
become local partial sums + ``psum``, and the n x n triangular core
stays replicated.  (A TSQR-based reduction is the next optimization
level; the sharded-GEMV formulation is already communication-light:
every collective is O(n) or O(1) per factorization step.)

Use :func:`solve_rowsharded` for a single giant-m instance on a mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.driver import Functions, init_carry, run_chunk
from ..core.types import (Carry, Dims, Options, Tols,
                          matmul_precision_scope)


def row_mesh(devices=None, axis: str = "rows") -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis,))


def _carry_shardings(carry: Carry, mesh: Mesh, axis: str):
    """Rows of the m-dimensional leaves sharded; everything else
    replicated.  (m-leaves: rx (m,), J (m, n).)"""
    rep = NamedSharding(mesh, P())
    rows1 = NamedSharding(mesh, P(axis))
    rows2 = NamedSharding(mesh, P(axis, None))
    m = carry.rx.shape[-1]

    def pick(leaf):
        if hasattr(leaf, "shape"):
            if leaf.ndim >= 1 and leaf.shape[-1] == m and leaf.ndim == 1:
                return rows1
            if leaf.ndim == 2 and leaf.shape[0] == m:
                return rows2
        return rep

    return jax.tree.map(pick, carry)


def _bind_rows(fns: Functions, data) -> Functions:
    """Append the problem data to every user callable's arguments."""
    if data is None:
        return fns
    return Functions(*(None if f is None else partial(_with_data, f, data)
                       for f in fns))


def _with_data(f, data, *args):
    return f(*args, data)


@partial(jax.jit, static_argnames=("fns", "dims", "opts"))
def _run_rows(carry, data, tols, fns, dims, opts):
    return run_chunk(carry, _bind_rows(fns, data), dims, opts, tols,
                     opts.max_iter + 1)


def solve_rowsharded(fns: Functions, x0, dims: Dims, opts: Options,
                     tols: Tols, mesh: Mesh | None = None,
                     axis: str = "rows", dtype=None, tsqr: bool = False,
                     data=None):
    """Solve ONE giant-m CNLS instance with residual rows sharded over
    ``mesh``.  m must divide the mesh size.  Newton is unavailable in
    this configuration (the reference itself force-disables second
    derivatives for n + m >= 1000, enlsip_functions.jl:2658); pass
    ``opts.second_derivatives=False``.

    ``tsqr=True`` switches the J2 factorization from GSPMD-partitioning
    of the pivot loop (one O(n) collective per step) to
    the two-stage TSQR reduction (ops/tsqr.py: local panel QRs + one
    gathered stacked-R pivoted QR — constant collective count per
    factorization, the multi-host-friendly choice).

    ``data`` (optional pytree): problem arrays the callables read, passed
    to the jitted solve as arguments (leaves with a leading m axis are
    sharded over the rows, the rest replicated) instead of being closed
    over, which would embed them in the program as constants.  The
    ``fns`` members then take the data as their last argument
    (``res(x, data)``, ``res_trial(x, p, data)``, ``jac_base(data)``).
    """
    import dataclasses

    mesh = mesh or row_mesh()
    x0 = jnp.asarray(x0)
    dtype = dtype or x0.dtype
    assert dims.m % mesh.devices.size == 0, (dims.m, mesh.devices.size)
    if tsqr:
        opts = dataclasses.replace(opts, tsqr_axis=axis)
        assert dims.m // mesh.devices.size >= dims.n, \
            "tsqr needs m/D >= n row panels"
    rows = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    if data is not None:
        data = jax.tree.map(lambda a: jax.device_put(
            a, rows if a.ndim and a.shape[0] == dims.m else rep), data)
    with jax.set_mesh(mesh), matmul_precision_scope(opts):
        carry = init_carry(_bind_rows(fns, data), x0, dims, opts, dtype)
        shardings = _carry_shardings(carry, mesh, axis)
        carry = jax.device_put(carry, shardings)
        carry = _run_rows(carry, data, tols, fns=fns, dims=dims, opts=opts)
    return carry
