"""Multistart solving: one problem, K perturbed starts, one launch.

The reference is a single-start solver — ``solve!`` runs from exactly
one ``starting_point`` (reference ``src/solver.jl:62-91``), so its
outcome on problems with alternate stationary points, degenerate
constraints, or divergent standard starts is whatever that one
trajectory produces (see PARITY.md's oracle-adjudicated hs2/hs13/
hs16/hs27 outcomes).  The batched framework's structural counter
costs one launch: solve the SAME problem from K perturbed starts as K
lanes of :func:`~enlsip_tpu.parallel.batch.solve_batched` and keep the
best converged lane.  ``benchmarks/hs_suite_bench.py`` drives this
machinery over the full HS suite (28/28 matched published optima vs
the single-start ceiling of 24/28, BENCH ``hs_suite_match_multistart``).

Selection rule: "best" = lowest f among lanes with ``exit_code > 0``.
The termination lattice negates exit codes at infeasible points
(reference ``enlsip_functions.jl:2471-2481``), so a positive code is
the solver's own feasible-convergence certificate.  Note that on
problems whose active constraint is degenerate at the optimum (hs13),
tolerance-feasible lanes can report f marginally below the exact
constrained optimum — the best-lane f is "optimum as seen at the
solver's constraint tolerance", same as any single solve.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.driver import Functions
from ..core.types import Dims, Options, Tols
from .batch import BatchResult, solve_batched


class MultistartResult(NamedTuple):
    x: jax.Array           # (n,) best converged solution (or lane 0's x)
    f: jax.Array           # scalar ||r(x)||^2 of that lane
    exit_code: jax.Array   # its exit code
    n_converged: int       # lanes with exit_code > 0
    best_lane: int         # index into ``batch``
    batch: BatchResult     # all K lanes


def perturbed_starts(x0, K: int, scale: float = 1.0, seed: int = 0,
                     include_x0: bool = True) -> np.ndarray:
    """(K, n) starts: ``x0 + scale*(1+|x0|)*N(0,1)`` per coordinate
    (the same spread rule as ``hs_scenario_batch``); lane 0 is the
    unperturbed ``x0`` when ``include_x0`` so multistart never does
    worse than the single-start solve."""
    x0 = np.asarray(x0, float)
    rng = np.random.default_rng(seed)
    starts = x0[None, :] + scale * (1.0 + np.abs(x0))[None, :] * \
        rng.normal(size=(K, x0.shape[0]))
    if include_x0:
        starts[0] = x0
    return starts


def solve_multistart(fns: Functions, x0, dims: Dims, opts: Options,
                     tols: Tols, K: int = 32, scale: float = 1.0,
                     seed: int = 0, dtype=jnp.float32,
                     escalate_f64: bool = False) -> MultistartResult:
    """Solve one CNLS problem from K perturbed starts in ONE batched
    launch; return the best converged lane (plus all lanes).

    ``escalate_f64``: additionally re-solve non-converged lanes at f64
    (:func:`~enlsip_tpu.parallel.batch.escalate_lanes_f64`) before
    selection — the right mode when f32 evaluation noise is the
    suspected cause of misses."""
    starts = perturbed_starts(x0, K, scale=scale, seed=seed)
    res = solve_batched(fns, starts, dims, opts, tols, dtype=dtype,
                        escalate_f64=escalate_f64)
    f = np.asarray(res.f, float)
    ec = np.asarray(res.exit_code)
    conv = ec > 0
    if conv.any():
        best = int(np.flatnonzero(conv)[np.argmin(f[conv])])
    else:  # nothing converged: surface lane 0's (standard-start) outcome
        best = 0
    return MultistartResult(x=res.x[best], f=res.f[best],
                            exit_code=res.exit_code[best],
                            n_converged=int(conv.sum()), best_lane=best,
                            batch=res)
