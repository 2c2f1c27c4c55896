"""Batched solves: vmap the whole masked ENLSIP iteration over a batch
of independent CNLS instances.

This is the data-parallel layer the reference does not have (SURVEY.md
§2.4): thousands of scenario instances of the *same-shaped* problem
(shared residual/constraint closures, per-lane scenario data via the
first-class ``data=`` pytree) advance together inside one jitted
``lax.while_loop``; converged lanes are frozen (guarded_body) and the
loop exits when every lane has terminated.

Under vmap the batch dimension is the wide axis: per-step work becomes
(B, rows) x (B, cols) outer products and (B, m, n) batched GEMMs, and
the tiny per-lane pivoted QRs run as one fused kernel on the GPU
(ops/pallas_batched_qr.py).  Sharding the batch axis across a ``Mesh``
runs each device's lanes on that device (see parallel/sharding.py).
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.batched import batched_guarded_body, bind_data
from ..core.driver import Functions, guarded_body, init_carry
from ..core.types import (Carry, Counters, Dims, Options, Tols,
                          matmul_precision_scope)


class BatchResult(NamedTuple):
    """Stacked per-lane results."""

    exit_code: jax.Array   # (B,) raw internal exit codes
    x: jax.Array           # (B, n)
    f: jax.Array           # (B,) ||r(x)||^2
    n_iter: jax.Array      # (B,)
    counters: Counters     # each (B,)
    escalated: jax.Array | None = None  # (B,) bool when escalate_f64 ran


def init_batch(fns: Functions, x0_batch: jax.Array, dims: Dims,
               opts: Options, dtype, data=(), rdims=None) -> Carry:
    """Vmapped init_carry over a (B, n) batch of starting points.

    ``data``: optional pytree of per-lane problem data with a leading
    batch axis on every leaf; when non-empty, the ``fns`` closures take
    ``(x, data_lane)`` and each lane sees its own slice.

    ``rdims``: optional per-lane RDims (leaves shaped (B,)) for
    heterogeneous fused batches (see parallel/hetero.py)."""
    if fns.jac_base is not None:
        raise ValueError(
            "the factored-Jacobian hook (Functions.jac_rowscale/jac_base) "
            "is a single-solve feature (init_carry/run_chunk/solve); the "
            "batched bodies would silently treat the (m, 1) scale as a "
            "dense Jacobian")
    return jax.vmap(
        lambda x0, d, rd: init_carry(bind_data(fns, d), x0, dims, opts,
                                     dtype, rd)
    )(jnp.asarray(x0_batch, dtype), data, rdims)


def run_batch(carry: Carry, fns: Functions, dims: Dims, opts: Options,
              tols: Tols, max_steps: int | None = None,
              specialized: bool = True, data=(), rdims=None,
              check_every: int = 1) -> Carry:
    """Advance every unconverged lane until all lanes terminate (or
    ``max_steps`` loop trips).

    ``specialized=True`` (default) uses the batch-specialized body
    (core/batched.py): rare expensive branches (second working-set
    round, F_L11, subspace, Newton) execute under batch-level conds and
    are skipped entirely whenever no live lane needs them; per-lane
    values are identical to the plain-vmap body.

    ``check_every``: body steps per convergence check.  Checking every
    k trips runs k body steps per ``jnp.any`` in the loop condition (an
    all-reduce every trip when a caller's jit shards the batch axis) at
    the price of up to k-1 extra lockstep trips at the tail (harmless:
    terminated lanes are frozen by guarded_body).  Per-lane results are
    unchanged for any value.

    Cap invariant: all lanes step in lockstep (a lane's nb_iter only
    advances while its exit_code == 0 and ``record``), so loop trips
    >= any lane's iteration count; max_iter + 2 trips suffice for every
    lane to reach its own -2 exit.  Lanes resumed from a checkpoint
    carry their nb_iter and hit -2 earlier, never later."""
    cap = max_steps if max_steps is not None else opts.max_iter + 2
    if specialized:
        body = partial(batched_guarded_body, fns=fns, dims=dims, opts=opts,
                       tols=tols, data=data, rdims=rdims)
    else:
        body = lambda c: jax.vmap(
            lambda c1, d, rd: guarded_body(c1, bind_data(fns, d), dims, opts,
                                           tols, rd))(c, data, rdims)

    def cond(state):
        c, trips = state
        return jnp.any(c.exit_code == 0) & (trips < cap)

    def step(state):
        c, trips = state
        if check_every > 1:
            c = lax.fori_loop(0, check_every, lambda _, cc: body(cc), c)
        else:
            c = body(c)
        return c, trips + check_every

    final, _ = lax.while_loop(cond, step, (carry, jnp.int32(0)))
    return final


def finalize(carry: Carry) -> BatchResult:
    f = jnp.sum(carry.rx * carry.rx, axis=-1)
    return BatchResult(exit_code=carry.exit_code, x=carry.x, f=f,
                       n_iter=carry.nb_iter, counters=carry.counters)


@partial(jax.jit, static_argnames=("fns", "dims", "opts", "max_steps",
                                   "dtype_name"))
def _solve_batched_jit(x0_batch, data, rdims, fns: Functions, dims: Dims,
                       opts: Options, tols: Tols, max_steps,
                       dtype_name) -> BatchResult:
    dtype = jnp.dtype(dtype_name)
    carry = init_batch(fns, x0_batch, dims, opts, dtype, data, rdims)
    carry = run_batch(carry, fns, dims, opts, tols, max_steps, data=data,
                      rdims=rdims)
    return finalize(carry)


@partial(jax.jit, static_argnames=("fns", "dims", "opts", "dtype_name"))
def _init_batch_jit(x0_batch, data, rdims, fns: Functions, dims: Dims,
                    opts: Options, dtype_name) -> Carry:
    return init_batch(fns, x0_batch, dims, opts, jnp.dtype(dtype_name),
                      data, rdims)


@partial(jax.jit, static_argnames=("fns", "dims", "opts"))
def _run_batch_chunk_jit(carry: Carry, tols: Tols, chunk, data, rdims,
                         fns: Functions, dims: Dims, opts: Options) -> Carry:
    """Up to ``chunk`` lockstep trips; ``chunk`` is TRACED so every chunk
    size shares one compiled executable (same scheme as the single-solve
    driver's _run_chunk_jit)."""
    body = partial(batched_guarded_body, fns=fns, dims=dims, opts=opts,
                   tols=tols, data=data, rdims=rdims)

    def cond(state):
        c, trips = state
        return jnp.any(c.exit_code == 0) & (trips < chunk)

    def step(state):
        c, trips = state
        return body(c), trips + 1

    final, _ = lax.while_loop(cond, step, (carry, jnp.int32(0)))
    return final


def escalate_lanes_f64(fns: Functions, x0_batch, dims: Dims, opts: Options,
                       res: BatchResult, data=None, rdims=None,
                       tols64: Tols | None = None,
                       mask=None) -> BatchResult:
    """Re-solve a lane subset of a batched f32 solve at f64 in ONE
    follow-up launch and merge.

    Default subset: lanes with exit_code <= 0 (aborted/unconverged);
    pass ``mask`` (B,)-bool to escalate e.g. known-miss lanes instead.
    Escalated lanes restart from their ORIGINAL x0 — the merged result
    is what an all-f64 solve of those lanes would produce, not a warm
    start from the f32 iterate.  Counters on escalated lanes are the
    SUM of both attempts (total evaluations actually spent).  Merged
    x/f are reported at f64.  The reference analogue is re-running
    solve! at a wider element type T (solver.jl:62)."""
    import numpy as np

    ec = np.asarray(res.exit_code)
    B = ec.shape[0]
    sel = np.where(ec <= 0)[0] if mask is None else \
        np.where(np.asarray(mask))[0]
    if sel.size == 0:
        return res._replace(escalated=jnp.zeros(B, bool))

    def slice_cast(a):
        a = np.asarray(a)[sel]
        return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) \
            else a

    x0_sel = np.asarray(x0_batch)[sel].astype(np.float64)
    data_sel = None if data is None else jax.tree.map(slice_cast, data)
    rdims_sel = None if rdims is None else jax.tree.map(
        lambda a: np.asarray(a)[sel], rdims)
    esc = np.zeros(B, bool)
    esc[sel] = True
    # The whole merge stays inside the x64 scope: outside it, f64
    # constructions silently canonicalize back to f32.
    with jax.enable_x64():
        # Built inside the scope: outside it an f64 Tols silently
        # truncates to f32.
        tols64 = tols64 if tols64 is not None else \
            Tols.for_dtype(jnp.float64)
        res64 = solve_batched(fns, x0_sel, dims, opts, tols64,
                              dtype=jnp.float64, data=data_sel,
                              rdims=rdims_sel)
        idx = jnp.asarray(sel)

        def merge(old, new):
            return jnp.asarray(old, new.dtype).at[idx].set(new)

        cnt = Counters(*(old.at[idx].add(new) for old, new in
                         zip(res.counters, res64.counters)))
        return BatchResult(
            exit_code=res.exit_code.at[idx].set(res64.exit_code),
            x=merge(res.x, res64.x), f=merge(res.f, res64.f),
            n_iter=res.n_iter.at[idx].set(res64.n_iter),
            counters=cnt, escalated=jnp.asarray(esc))


def solve_batched(fns: Functions, x0_batch, dims: Dims, opts: Options,
                  tols: Tols, dtype=None, data=None, rdims=None,
                  time_limit: float | None = None,
                  escalate_f64: bool = False,
                  escalate_mask=None) -> BatchResult:
    """One-call batched solve of B same-shaped CNLS instances.

    ``fns`` must be hashable (e.g. a Functions of top-level closures).
    ``data`` is an optional pytree of per-lane problem data (scenario
    observations, targets, ...) whose leaves all carry a leading batch
    axis of size B; when given, every closure in ``fns`` takes
    ``(x, data)`` and lane i is called with ``data`` sliced at i.
    ``rdims``: per-lane RDims (int32 leaves shaped (B,)) for
    heterogeneous fused batches; see parallel/hetero.py.

    ``time_limit``: wall-clock budget in seconds (reference
    enlsip_functions.jl:2836, 2511-2512 checks elapsed time every
    iteration).  With the default (``None`` / ``inf``: unlimited) the
    whole batch is ONE dispatch; any finite limit runs adaptive chunks
    (one measured trip, then chunks sized to half the remaining budget)
    and lanes still running when the budget expires exit -11
    (:time_limit_exceeded), exactly like the single-solve driver.

    ``escalate_f64``: opt-in hybrid precision — after the solve, lanes
    with exit_code <= 0 are re-solved from their original x0 at f64 in
    one follow-up launch (see :func:`escalate_lanes_f64`).
    ``escalate_mask``: explicit (B,)-bool lane subset to escalate
    instead of the exit-code rule (implies escalation).
    """
    x0_batch = jnp.asarray(x0_batch)
    dtype = dtype or x0_batch.dtype
    data = () if data is None else jax.tree.map(jnp.asarray, data)

    def maybe_escalate(res):
        if not escalate_f64 and escalate_mask is None:
            return res
        return escalate_lanes_f64(fns, x0_batch, dims, opts, res, data=data,
                                  rdims=rdims, mask=escalate_mask)

    with matmul_precision_scope(opts):
        if time_limit is None or time_limit == float("inf"):
            return maybe_escalate(_solve_batched_jit(
                x0_batch.astype(dtype), data, rdims, fns, dims, opts, tols,
                None, jnp.dtype(dtype).name))
        start_time = time.time()
        carry = _init_batch_jit(x0_batch.astype(dtype), data, rdims, fns,
                                dims, opts, jnp.dtype(dtype).name)
        cap = opts.max_iter + 2
        per_trip = None
        while True:
            remaining_t = time_limit - (time.time() - start_time)
            if remaining_t <= 0:
                # Budget exhausted: still-running lanes exit -11.
                carry = carry._replace(exit_code=jnp.where(
                    carry.exit_code == 0, jnp.int32(-11), carry.exit_code))
                break
            if per_trip is None:
                chunk = 1  # measurement trip (absorbs cold compile too)
            else:
                chunk = max(1, min(cap, int(0.5 * remaining_t / per_trip)))
            t0 = time.time()
            carry = _run_batch_chunk_jit(carry, tols, jnp.int32(chunk), data,
                                         rdims, fns, dims, opts)
            any_running = bool(jnp.any(carry.exit_code == 0))  # syncs
            dt = time.time() - t0
            measured = dt / chunk
            per_trip = measured if per_trip is None else max(0.5 * per_trip,
                                                             measured)
            if not any_running:
                break
        return maybe_escalate(finalize(carry))
