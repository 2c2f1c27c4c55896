"""Heterogeneous fused batching: instances of DIFFERENT problem
families solved in ONE jitted batched launch.

The BASELINE "multi-host scenario batch" config mixes instances of
different CNLS families with different (n, m, q, l).  Under jit those
are buffer shapes, so the fused design pads every family into shared
max-size buffers and threads the TRUE dimensions through the solver as
per-lane traced :class:`~enlsip_tpu.core.types.RDims` (the decision
logic compares against them; the masked kernels are unchanged).  The
padding is engineered to be inert:

* residuals: rows >= m_f are exactly 0 (zero J rows, zero ||r||^2
  contribution);
* parameters: coordinates >= n_f never enter any closure, giving zero
  Jacobian columns — the pivoted factorizations treat them like the
  already-handled dead columns, and the Newton block excludes them
  (core/subproblem.py);
* constraints: rows >= l_f return the constant ``PAD_CX`` (large
  positive, zero A rows) — never activated by INIALC/EVADD, never
  violated, never steplength-capping — and the driver's cx_sum masks
  them out of the reference's dot(cx, cx) (enlsip_functions.jl:1147).

Per lane the trajectory is therefore IDENTICAL to the same instance
solved in a homogeneous (bucketed) batch — asserted by
tests/test_hetero.py.  Each lane's closures dispatch on a per-lane
family id carried in the ``data`` pytree (``lax.switch``; under vmap
every lane evaluates every family's residual — cheap next to the
factorizations, which run once on the shared max-size buffers).

No reference counterpart: the reference (Enlsip.jl) solves one
instance at a time (enlsip_functions.jl:2776-2878).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.driver import Functions
from ..core.types import Dims, Options, RDims
from .batch import BatchResult, solve_batched
from .sharding import solve_batched_sharded
from .suite import FamilySpec

PAD_CX = 1e4  # inert padding constraint value (>> EVADD's delta = 0.1)


class FusedSuite(NamedTuple):
    """A fused heterogeneous batch ready for one solve_batched call."""

    fns: Functions        # union closures taking (x, data)
    dims: Dims            # buffer maxima over all families
    x0: jax.Array         # (B, n_max) zero-padded starts
    data: dict            # {'fam': (B,) int32} (+ user data if any)
    rdims: RDims          # per-lane true dims, (B,) int32 leaves
    slices: dict          # {family name: slice into the B lanes}
    fstar: dict           # {family name: known optimum or None}


def _pad_family(fns: Functions, d: Dims, dmax: Dims) -> Functions:
    """Closures over the padded x that compute with the family's true
    leading coordinates and emit padded, inert outputs."""
    n, m, l = d.n, d.m, d.l
    N, M, L = dmax.n, dmax.m, dmax.l

    def res(x):
        r = fns.res(x[:n])
        return jnp.zeros(M, x.dtype).at[:m].set(r)

    def jac_res(x):
        J = fns.jac_res(x[:n])
        return jnp.zeros((M, N), x.dtype).at[:m, :n].set(J)

    def cons(x):
        c = fns.cons(x[:n])
        return jnp.full(L, jnp.asarray(PAD_CX, x.dtype)).at[:l].set(c)

    def jac_cons(x):
        A = fns.jac_cons(x[:n])
        return jnp.zeros((L, N), x.dtype).at[:l, :n].set(A)

    return Functions(res=res, jac_res=jac_res, cons=cons, jac_cons=jac_cons)


def fuse_families(families: dict) -> FusedSuite:
    """Build the union closures + per-lane metadata for one fused batch.

    ``families``: {name: FamilySpec} as produced by
    :func:`enlsip_tpu.parallel.suite.hs_scenario_batch`.
    """
    specs = list(families.items())
    dmax = Dims(n=max(s.dims.n for _, s in specs),
                m=max(s.dims.m for _, s in specs),
                q=max(s.dims.q for _, s in specs),
                l=max(s.dims.l for _, s in specs))
    padded = [_pad_family(s.fns, s.dims, dmax) for _, s in specs]

    def union(field):
        branches = [getattr(p, field) for p in padded]

        def f(x, data):
            return lax.switch(data["fam"], branches, x)

        return f

    fns = Functions(res=union("res"), jac_res=union("jac_res"),
                    cons=union("cons"), jac_cons=union("jac_cons"))

    x0s, fam_ids, rd_rows, slices = [], [], [], {}
    off = 0
    for fid, (name, s) in enumerate(specs):
        Bf = s.x0_batch.shape[0]
        x0s.append(np.pad(np.asarray(s.x0_batch),
                          ((0, 0), (0, dmax.n - s.dims.n))))
        fam_ids.append(np.full(Bf, fid, np.int32))
        rd_rows.append(np.tile([s.dims.n, s.dims.m, s.dims.q, s.dims.l],
                               (Bf, 1)).astype(np.int32))
        slices[name] = slice(off, off + Bf)
        off += Bf
    rd = np.concatenate(rd_rows)
    rdims = RDims(n=jnp.asarray(rd[:, 0]), m=jnp.asarray(rd[:, 1]),
                  q=jnp.asarray(rd[:, 2]), l=jnp.asarray(rd[:, 3]))
    return FusedSuite(
        fns=fns, dims=dmax, x0=jnp.asarray(np.concatenate(x0s)),
        data={"fam": jnp.asarray(np.concatenate(fam_ids))}, rdims=rdims,
        slices=slices, fstar={name: s.fstar for name, s in specs})


def solve_suite_fused(families: dict, opts: Options, tols_fn,
                      mesh=None, dtype=jnp.float32, fused=None,
                      escalate_f64: bool = False) -> dict:
    """Solve a mixed-family scenario batch in ONE fused launch;
    returns {name: BatchResult} (split back per family).

    Compare :func:`enlsip_tpu.parallel.suite.solve_suite_batched`, which
    runs one launch per family (no padding, but f families = f
    sequential dispatches and f compilations).

    ``fused``: optional prebuilt :func:`fuse_families` result.  The
    union closures inside a FusedSuite are the solver's jit cache key
    (static ``fns``), so repeat solves of the same suite MUST reuse one
    FusedSuite or every call pays a full recompile."""
    if escalate_f64 and mesh is not None:
        raise ValueError(
            "escalate_f64 is not wired through the sharded path; run the "
            "mesh solve, then escalate flagged lanes explicitly via "
            "solve_batched(..., escalate_mask=...)")
    if fused is None:
        fused = fuse_families(families)
    tols = tols_fn(dtype)
    if mesh is not None:
        res = solve_batched_sharded(fused.fns, fused.x0, fused.dims, opts,
                                    tols, mesh=mesh, dtype=dtype,
                                    data=fused.data, rdims=fused.rdims)
    else:
        res = solve_batched(fused.fns, fused.x0, fused.dims, opts, tols,
                            dtype=dtype, data=fused.data, rdims=fused.rdims,
                            escalate_f64=escalate_f64)

    out = {}
    for name, sl in fused.slices.items():
        nf = families[name].dims.n
        out[name] = BatchResult(
            exit_code=res.exit_code[sl], x=res.x[sl, :nf], f=res.f[sl],
            n_iter=res.n_iter[sl],
            counters=jax.tree.map(lambda a: a[sl], res.counters),
            escalated=(None if res.escalated is None
                       else res.escalated[sl]))
    return out
