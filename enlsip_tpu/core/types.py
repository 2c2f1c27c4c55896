"""State pytrees and static configuration for the ENLSIP solver.

The reference threads a mutable ``Iteration`` record plus a
``WorkingSet`` through its loop (/root/reference/src/structures.jl:63-98,
209-229).  Here the solver is a pure function of a single fixed-shape
carry pytree; the working set is a boolean mask over the ``l``
constraints, and every data-dependent dimension (t, rankA, rankJ2,
dimA, dimJ2) is a traced int32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Dims:
    """Static problem dimensions (hashable; part of the jit cache key).

    n: parameters, m: residuals, q: equality constraints,
    l: total constraints.
    """

    n: int
    m: int
    q: int
    l: int

    @property
    def tmax(self) -> int:
        """Working-set slot-buffer size.  The reference's INIALC can
        activate every non-positive inequality (enlsip_functions.jl:
        847-855) — t is NOT capped at n at initialization; only EVADD
        enforces t <= min(l, n) (:617).  Buffers are therefore l-sized.
        """
        return self.l

    @property
    def ka(self) -> int:
        """Rank cap of the active-constraint factorization:
        rankA <= min(n, l) (the R factor of A^T is (ka, l))."""
        return min(self.n, self.l)


class RDims(NamedTuple):
    """Runtime (possibly traced, possibly per-lane) problem dimensions.

    :class:`Dims` fixes the BUFFER shapes (static maxima under jit);
    ``RDims`` carries the SEMANTIC dimensions the algorithm's decision
    logic compares against (e.g. GNDCHK's ``m == n - t``, the EVADD
    capacity bound ``min(l, n)``, TERCRI's ``t > q``).  For ordinary
    homogeneous solves the two coincide and ``RDims.of(dims)`` yields
    plain Python ints (compile-time constants — identical HLO to not
    threading them at all).  For heterogeneous fused batches
    (parallel/hetero.py) the leaves are per-lane int32 arrays: each
    lane's problem occupies the leading n/m/q..l slots of the shared
    max-size buffers and the padding is engineered to be inert
    (zero residual rows, zero Jacobian columns, never-active dummy
    constraints)."""

    n: jax.Array | int
    m: jax.Array | int
    q: jax.Array | int
    l: jax.Array | int

    @staticmethod
    def of(dims: "Dims") -> "RDims":
        return RDims(n=dims.n, m=dims.m, q=dims.q, l=dims.l)


def rdims_or(rdims, dims: "Dims") -> RDims:
    """The semantic dims to use: ``rdims`` if given, else the static ones."""
    return rdims if rdims is not None else RDims.of(dims)


@dataclasses.dataclass(frozen=True)
class Options:
    """Solver options; mirrors ``enlsip(...)`` keywords
    (enlsip_functions.jl:2638-2655) and ``solve!`` tolerance mapping
    (solver.jl:62-81).  Static fields only; tolerances are carried as
    jnp scalars in :class:`Tols` to avoid re-jitting on tolerance
    changes.
    """

    scaling: bool = False
    second_derivatives: bool = True
    weight_code: int = 2  # 0 = max-norm, 2 = euclidean norm
    max_iter: int = 100
    # Bounded inner-loop trip counts (the reference loops are unbounded
    # but terminate in practice; these caps guarantee jit termination).
    linesearch_max_refine: int = 30
    gac_max_halvings: int = 60
    eucmod_max_passes: int = 16
    # Giant-m row-sharded factorization: when set (mesh axis name), the
    # J2 factorization uses a two-stage reduction (ops/tsqr.py)
    # instead of GSPMD-partitioning the pivot loop.  Requires an ambient
    # mesh (jax.set_mesh) whose named axis shards the residual rows.
    tsqr_axis: str | None = None
    # Tall-panel (m >> n) J2 factorization method, both single-device
    # and row-sharded: "cholqr" (shifted CholeskyQR + pivoted QR of R1,
    # implicit Q, GEMM speed, one psum when sharded; ops/tsqr.CholQRF)
    # or "qr" (Householder thin QR first stage; numerically safest for
    # cond(J2) beyond ~1/sqrt(eps), much slower at millions of rows).
    tall_qr: str = "cholqr"
    # Matmul precision for every dot/GEMM inside this solve.
    # Accelerator matmuls may run f32 inputs in reduced precision by
    # default (TF32 on NVIDIA GPUs), which costs ~3 decimal digits
    # through the factorization chains and drops HS-suite optimum
    # matches; "float32" (the default) forces IEEE f32 products for
    # reference-grade accuracy.  "bfloat16"/"tensorfloat32" opt back
    # into the fast tensor-core passes per solve for users who accept
    # the accuracy trade: the analogue of the reference's per-call
    # element type T (solver.jl:62).  None inherits the ambient jax
    # default (no scope is installed).
    matmul_precision: str | None = "float32"
    # D13 (f32 only; no effect at f64): allow the second-order
    # working-set deletion round on a pseudo-rank-DEFICIENT
    # factorization when the iterate is otherwise stationary, holds a
    # genuinely negative multiplier, and shows stall evidence — the
    # deadlock the reference's full-rank-only gate
    # (enlsip_functions.jl:745-790) cannot resolve at f32 rank drops.
    # See core/driver._ws_round1 and PARITY.md D13.
    rank_deficient_deletion: bool = True


def matmul_precision_scope(opts: "Options"):
    """Context manager scoping ``jax_default_matmul_precision`` to one
    solve entry point.  The setting is thread-local and part of JAX's
    trace context (each value traces/compiles its own executable), so
    the process-global default the user may have set is never touched
    (and import order does not matter)."""
    if opts.matmul_precision is None:
        return contextlib.nullcontext()
    return jax.default_matmul_precision(opts.matmul_precision)


def acc(v):
    """Promote decision-path scalars/vectors to f64 when available
    (no-op for f64 solves; see linesearch.py rationale)."""
    if jax.config.jax_enable_x64:
        return jnp.asarray(v, jnp.float64)
    return v


class Tols(NamedTuple):
    """Traced tolerance bundle (defaults set in api layer from eps(T))."""

    eps_abs: jax.Array
    eps_rel: jax.Array
    eps_x: jax.Array
    eps_c: jax.Array
    eps_rank: jax.Array

    @classmethod
    def for_dtype(cls, dtype) -> "Tols":
        """The reference's eps(T)-scaled defaults (solver.jl:62-63,80-81
        incl. the internal eps_abs=1e-10 quirk): rel = sqrt(eps(T)),
        c/x/rank tolerances = rel."""
        rel = float(jnp.finfo(dtype).eps) ** 0.5
        return cls(*(jnp.asarray(v, dtype)
                     for v in (1e-10, rel, rel, rel, rel)))


class Counters(NamedTuple):
    """Evaluation counters — observable via ExecutionInfo
    (cnls_model.jl:11-36, 97-104)."""

    nb_res: jax.Array
    nb_jacres: jax.Array
    nb_cons: jax.Array
    nb_jaccons: jax.Array

    @staticmethod
    def zeros() -> "Counters":
        z = jnp.int32(0)
        return Counters(z, z, z, z)


class PrevIter(NamedTuple):
    """Snapshot of the previous iteration, as read by GNDCHK / SUBSPC /
    STPLNG / TERCRI.  Captured at end-of-body with the semantics of the
    reference's ``previous_iter = copy(iter)`` (enlsip_functions.jl:2860):
    ``x``/``rx_sum``/``cx_sum`` are the values at the *start* of that
    body (the point where its direction was computed)."""

    x: jax.Array          # (n,)
    rx_sum: jax.Array     # ||r(x_prev)||^2
    cx_sum: jax.Array     # ||c(x_prev)||^2 (full vector)
    t: jax.Array          # working-set size at direction time
    alpha: jax.Array
    beta: jax.Array
    code: jax.Array       # 1 GN, -1 subspace, 2 Newton
    w: jax.Array          # (l,) penalty weights used
    progress: jax.Array
    predicted_reduction: jax.Array
    rankA: jax.Array
    rankJ2: jax.Array
    dimA: jax.Array
    dimJ2: jax.Array


class Carry(NamedTuple):
    """The full solver loop carry."""

    x: jax.Array          # (n,) current point
    rx: jax.Array         # (m,)
    cx: jax.Array         # (l,)
    J: jax.Array          # (m, n)
    A: jax.Array          # (l, n)
    gf: jax.Array         # (n,) gradient J^T rx
    active_mask: jax.Array  # (l,) bool working set
    w: jax.Array          # (l,) current penalty weights
    K: jax.Array          # (4, l) penalty history (largest-4 per constraint)
    prev: PrevIter
    restart: jax.Array    # bool, current iter restart flag (carried)
    index_del: jax.Array  # int32 global constraint index, 0 = none (carried!)
    nb_newton_steps: jax.Array
    nb_iter: jax.Array
    exit_code: jax.Array
    counters: Counters
    display: jax.Array    # (max_iter+1, 5): objective, act_cx_sum, |p|, alpha, progress
    n_display: jax.Array  # number of valid display rows


class WorkingView(NamedTuple):
    """Derived view of the working set for one mask state.

    active_list: (l,) int32 — first t entries are the sorted active
      constraint indices, the remaining l-t entries are the sorted
      inactive ones (this single argsort reproduces both of the
      reference's ``active``/``inactive`` arrays, structures.jl:209-229).
    t: traced active count.
    """

    active_list: jax.Array
    t: jax.Array


def working_view(mask: jax.Array) -> WorkingView:
    l = mask.shape[0]
    idx = jnp.arange(l, dtype=jnp.int32)
    key = jnp.where(mask, idx, idx + l)
    order = jnp.argsort(key).astype(jnp.int32)
    return WorkingView(active_list=order, t=jnp.sum(mask).astype(jnp.int32))
