"""TSQR-style two-stage column-pivoted QR for row-sharded tall matrices.

The giant-m configuration (SURVEY.md §5.7) shards the m residual rows
over the device mesh.  The default path lets GSPMD partition the
sequential pivoted-QR loop of ops/blocked_qr.py: correct, and cheap
between the devices of one host (every collective is O(n) per step),
but each of the ~n steps synchronizes, which hurts when the mesh spans
hosts (network latency).
This module provides the classic communication-optimal alternative:

  stage 1 (local, zero communication): each shard factors its own
    (m/D, n) row panel with an unpivoted thin QR,
  stage 2 (replicated, one gather): the stacked local R factors
    (D*n, n) — whose columns have exactly the full matrix's column
    norms — are factored by the existing blocked *pivoted* QR.

  M P = blockdiag(Qloc_d) . embed(Q_S) . [R; 0]

R, perm and diag equal the direct CPQR's mathematically (pivoting
decisions depend only on column norms, which stage 1 preserves), so
rank logic and triangular solves are unchanged.  Q stays implicit as
the two-level composition; ``qt_apply_tsqr`` applies it with one local
GEMV + one small replicated apply — ONE gather per application instead
of one per factorization step.

Total communication per factorization: one (D*n, n) gather + one (D*n,)
gather, independent of the number of pivot steps.

No reference counterpart (the reference is single-process,
enlsip_functions.jl:223 ``qr(J2, ColumnNorm())``); the BASELINE's
"row-sharded Jacobian with Schur/TSQR reduction across hosts" names
this component.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .blocked_qr import CPQRF, cpqr_blocked, qt_apply


@jax.tree_util.register_pytree_node_class
class TSQRF:
    """Two-stage implicit-Q pivoted QR of a row-sharded (m, n) matrix.

    qloc: (m, n) row-sharded block-diagonal thin local Q factors;
    f2: replicated CPQR of the stacked local Rs ((D*n, n) buffer);
    axis: mesh axis name the rows are sharded over (static aux data);
    ``axis=None`` is the SINGLE-DEVICE tall-skinny variant (D = 1): one
    unpivoted thin QR of the whole matrix + pivoted QR of its (n, n)
    R, one blocked pass over the tall data instead of the
    sequential per-column pivot loop (the auto-dispatch for
    m >> n in core/subproblem.gn_search_direction).
    Exposes R/perm/diag with the shapes the direct CPQRF would have for
    m >= n, so FactorJ2's properties are oblivious."""

    def __init__(self, qloc, f2: CPQRF, axis: str | None):
        self.qloc = qloc
        self.f2 = f2
        self.axis = axis

    def tree_flatten(self):
        return (self.qloc, self.f2), self.axis

    @classmethod
    def tree_unflatten(cls, axis, children):
        return cls(children[0], children[1], axis)

    @property
    def R(self):
        return self.f2.R[: self.qloc.shape[1]]

    @property
    def perm(self):
        return self.f2.perm

    @property
    def diag(self):
        return self.f2.diag[: self.qloc.shape[1]]


def _axis_size(axis: str) -> int:
    mesh = jax.sharding.get_abstract_mesh()
    if mesh is None or axis not in mesh.shape:
        raise ValueError(
            f"tsqr requires an ambient mesh with axis {axis!r}; "
            "wrap the solve in jax.set_mesh(mesh)")
    return mesh.shape[axis]


def tsqr_cpqr(M: jax.Array, nsteps, axis: str | None) -> TSQRF:
    """Column-pivoted QR of the row-sharded ``M`` ((m, n), m % D == 0,
    m/D >= n) via local thin QRs + replicated pivoted QR of the stacked
    R factors.  ``nsteps`` bounds stage 2's pivot steps (live columns).

    ``axis=None``: single-chip tall-skinny path — one thin
    ``jnp.linalg.qr`` of the whole matrix, then CPQR of its (n, n) R.
    Column norms (hence pivoting and rank decisions) are preserved
    exactly as in the sharded case."""
    m, n = M.shape
    if axis is None:
        q, r = jnp.linalg.qr(M, mode="reduced")
        return TSQRF(qloc=q, f2=cpqr_blocked(r, nsteps=nsteps), axis=None)
    D = _axis_size(axis)
    assert m % D == 0 and m // D >= n, (m, n, D)
    P = jax.sharding.PartitionSpec

    def local_qr(Md):
        q, r = jnp.linalg.qr(Md, mode="reduced")
        return tuple((q, r))  # plain tuple (QRResult confuses out_specs)

    qloc, r_stack = jax.shard_map(
        local_qr, in_specs=P(axis, None),
        out_specs=(P(axis, None), P(axis, None)))(M)
    # r_stack is (D*n, n): shard d's rows [d*n, (d+1)*n) hold its local R.
    f2 = cpqr_blocked(r_stack, nsteps=nsteps)
    return TSQRF(qloc=qloc, f2=f2, axis=axis)


@jax.tree_util.register_pytree_node_class
class CholQRF:
    """Shifted CholeskyQR + pivoted QR of the (n, n) triangular factor,
    the GEMM-speed factorization for tall J2 panels.

    XLA's Householder thin QR on a (5M, 100) buffer is a sequential
    column loop far below GEMM rate, while the Gram contraction
    G = M^T M is one large GEMM.  So: R1 = chol(G + shift*I)^T-free
    upper factor, and Q = M R1^{-1} kept IMPLICIT — no (m, n) Q buffer
    is ever materialized; Q^T v costs one M^T GEMV + one (n, n)
    triangular solve.

    Stage 2 (cpqr_blocked of R1) pivots and ranks exactly like the TSQR
    path: R1's column norms equal M's (diag(G)), so pivoting decisions
    agree.  The shift eps*max(diag G) keeps the Cholesky finite when
    live columns are numerically dependent (G is PSD, so lambda_min of
    the shifted Gram >= shift); MASKED dead columns (exact zeros in the
    J2 buffer) are re-zeroed in R1 after the factorization so
    pseudo_rank never sees shift artifacts.  Rank-deficiency detection
    happens in stage 2's diag exactly as before.

    Under a row-sharded mesh the Gram contracts the sharded axis —
    GSPMD inserts ONE (n, n) psum: communication-optimal (no (D*n, n)
    gather, no per-step collectives), the classic CholeskyQR advantage.

    Numerical envelope: cond(G) = cond(M)^2, so the implicit Q loses
    orthogonality for cond(M) beyond ~1/eps^(1/2) (~2e3 at f32).  For
    the GN subproblem this perturbs the direction, not correctness
    (descent is re-checked by the merit machinery); parity tests pin
    the well-conditioned agreement, and ``Options(tall_qr="qr")``
    restores the Householder path.
    """

    def __init__(self, M, R1, f2: CPQRF, R2=None, G=None):
        self.M = M        # (m, n) the factored buffer (not copied)
        self.R1 = R1      # (n, n) upper, dead columns zeroed
        self.f2 = f2      # CPQR of R2 @ R1 (the refined factor)
        # Refinement factor of the CholeskyQR2 pass (None: single-pass
        # factorization, implicit Q = M R1^{-1}).  Kept SEPARATE from R1
        # so qt_apply composes two backward-stable solves instead of
        # solving with the rounded product fl(R2 @ R1), whose error the
        # cond^2 amplification would reintroduce.
        self.R2 = R2
        # UNMASKED Gram M^T M — free to keep (it was computed anyway),
        # and it lets consumers replace (m,)-length streams with (n, n)
        # matvecs: M^T (M y) == G y exactly in real arithmetic, so e.g.
        # the GN d-vector and the LEAEST rhs never re-stream the tall
        # buffer (benchmarks/giant_m_profile.py attribution).
        self.G = G

    def tree_flatten(self):
        return (self.M, self.R1, self.f2, self.R2, self.G), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def R(self):
        return self.f2.R[: self.M.shape[1]]

    @property
    def perm(self):
        return self.f2.perm

    @property
    def diag(self):
        return self.f2.diag[: self.M.shape[1]]


def cholqr_cpqr(M: jax.Array, nsteps, col_live=None) -> CholQRF:
    """Column-pivoted QR of a tall (m, n) buffer via shifted CholeskyQR
    (implicit Q) + pivoted QR of R1.  Works transparently row-sharded:
    the Gram GEMM contracts the sharded axis (one psum).

    At f64 a CholeskyQR2-style refinement pass (Fukaya et al., shifted
    CholeskyQR2) runs: implicit Q becomes M R1^{-1} R2^{-1} with
    R2 = chol(R1^{-T} G R1^{-1})^T.  It reuses the Gram — two (n, n)
    triangular solves + one (n, n) Cholesky, NO second (m, n) pass and
    NO extra collective — and improves the implicit Q's orthogonality
    by ~2 decades in the mid-conditioning range (measured 2.7e-6 vs
    2.0e-4 at cond(M)=1e6; the analytic-Gram reuse, not the classical
    explicit-Q Gram, bounds the gain — an explicit pass would need the
    (m, n) Q buffer this design exists to avoid).  At f32 the pass is
    SKIPPED: measured gains are <= 4x below cond ~1e3 and it can
    destabilize beyond cond ~1e4 — a regime the f32 solver's own
    pseudo-rank truncation (eps_rank = sqrt(eps) ~ 3e-4) cuts off
    anyway.  Round-3 advisor guard; for cond(M) beyond the envelope at
    either dtype, set ``Options(tall_qr="qr")`` (Householder path,
    recommended in docs/tutorial.md's giant-m section)."""
    from jax.scipy.linalg import solve_triangular
    n = M.shape[1]
    G_raw = M.T @ M                                 # (n, n)
    G = G_raw
    if col_live is not None:
        # Dead-column masking moved to the SMALL side: the live-live
        # block of G is bitwise identical whether the (m, n) buffer or
        # the (n, n) Gram is masked, so passing the UNMASKED buffer
        # (e.g. JQ1) avoids materializing a second (m, n) masked copy
        # per factorization (a full device-memory round trip on
        # giant-m).  qt_apply_cholqr already
        # masks its (n,) projection by R1-diag liveness.
        G = jnp.where(col_live[None, :] & col_live[:, None], G, 0.0)
    dG = jnp.diagonal(G)
    live = dG > 0.0
    eps = jnp.finfo(M.dtype).eps
    shift = eps * jnp.max(dG)
    eye = jnp.eye(n, dtype=M.dtype)
    Gs = G + shift * eye
    L = jnp.linalg.cholesky(Gs)                     # lower
    R1 = L.T
    # Exact-zero (masked) columns must stay exactly zero so stage-2
    # pivoting/rank logic never sees the shift; NaNs (all-dead Gram)
    # collapse to zero the same way.
    live2 = live[None, :] & live[:, None]
    R1 = jnp.where(live[None, :] & jnp.isfinite(R1), R1, 0.0)
    if jnp.finfo(M.dtype).eps > jnp.finfo(jnp.float64).eps:
        # f32: single pass (see class docstring for the envelope).
        return CholQRF(M=M, R1=R1, f2=cpqr_blocked(R1, nsteps=nsteps),
                       G=G_raw)
    # --- f64 refinement pass (implicit CholeskyQR2) --------------------
    # G_Q = R1^{-T} G R1^{-1} is the Gram of the implicit Q; its
    # Cholesky factor R2 measures (and removes) the orthogonality loss.
    # Dead rows/cols are patched to the identity for the solves and
    # re-zeroed after.
    R1p = R1 + jnp.where(live, 0.0, 1.0) * eye
    Gl = jnp.where(live2, G, 0.0) + jnp.where(live, 0.0, 1.0) * eye
    X = solve_triangular(R1p, Gl, trans=1, lower=False)      # R1^{-T} G
    GQ = solve_triangular(R1p, X.T, trans=1, lower=False).T  # X R1^{-1}
    GQ = 0.5 * (GQ + GQ.T)
    shift2 = eps * jnp.max(jnp.diagonal(GQ))
    L2 = jnp.linalg.cholesky(GQ + shift2 * eye)
    R2 = jnp.where(live2 & jnp.isfinite(L2.T), L2.T, 0.0)
    # Guard against a failed refinement Cholesky (NaN row wipe): fall
    # back to the single-pass factor for any column the refinement
    # killed but the first pass kept.
    ref_ok = jnp.all(jnp.where(live, jnp.diagonal(R2) > 0.0, True))
    R2 = jnp.where(ref_ok, R2, jnp.where(live, 1.0, 0.0) * eye)
    # Stage-2 pivoting/ranks read the refined product; the implicit-Q
    # application composes the two factors (see CholQRF.R2).
    Rr = jnp.where(live[None, :], R2 @ R1, 0.0)
    return CholQRF(M=M, R1=R1, f2=cpqr_blocked(Rr, nsteps=nsteps), R2=R2,
                   G=G_raw)


def qt_apply_cholqr_from_projection(f: CholQRF, y: jax.Array,
                                    v_sq: jax.Array) -> jax.Array:
    """qt_apply_cholqr given the projection y = M^T v and ||v||^2
    ALREADY computed — lets callers who can form both from small-side
    quantities (y = G a + M^T b combinations) skip streaming the tall
    buffer entirely."""
    return _qt_cholqr(f, y, v_sq)


def qt_apply_cholqr(f: CholQRF, v: jax.Array) -> jax.Array:
    """Q^T v with the same (m,) embedding contract as qt_apply_tsqr:
    leading n entries are the stage-2 coefficients, entry [n] carries
    the orthogonal-complement norm (sum(out**2) == ||v||**2)."""
    return _qt_cholqr(f, f.M.T @ v, jnp.sum(v * v))


def _qt_cholqr(f: CholQRF, y: jax.Array, v_sq: jax.Array) -> jax.Array:
    from jax.scipy.linalg import solve_triangular
    m, n = f.M.shape
    # R1^T w = y on the live columns; dead rows/cols of R1 are zero, so
    # solve on a unit-diagonal-patched copy and re-zero.
    live = jnp.abs(jnp.diagonal(f.R1)) > 0.0
    eye = jnp.eye(n, dtype=f.R1.dtype)
    R1p = f.R1 + jnp.where(live, 0.0, 1.0) * eye
    w = solve_triangular(R1p, jnp.where(live, y, 0.0), trans=1, lower=False)
    w = jnp.where(live, w, 0.0)
    if f.R2 is not None:
        # CholeskyQR2 composition: Q = M R1^{-1} R2^{-1}.
        R2p = f.R2 + jnp.where(live, 0.0, 1.0) * eye
        w = solve_triangular(R2p, w, trans=1, lower=False)
        w = jnp.where(live, w, 0.0)
    u = qt_apply(f.f2, w)                           # (n,) replicated
    rest2 = jnp.maximum(v_sq - jnp.sum(w * w), 0.0)
    out = jnp.zeros(m, y.dtype)
    out = out.at[:n].set(u[:n])
    out = out.at[n].set(jnp.sqrt(rest2))
    return out


def qt_apply_tsqr(f: TSQRF, v: jax.Array) -> jax.Array:
    """Q^T v embedded in an (m,) buffer whose leading D*n entries are
    the stacked-basis coefficients (exact for every consumer: the
    triangular solves and prefix norms all read < n leading entries)
    and whose entry [D*n] carries the orthogonal-complement norm, so
    ``sum(out**2) == ||v||**2`` like the direct transform.  (Entries in
    (n, D*n) differ from the direct CPQR's by an orthogonal rotation of
    the complement — no consumer reads them individually.)"""
    m, n = f.qloc.shape
    dn = f.f2.V.shape[0]
    if f.axis is None:
        w = f.qloc.T @ v                               # (n,)
    else:
        P = jax.sharding.PartitionSpec

        def local_qt(qd, vd):
            return qd.T @ vd  # (n,) per shard

        w = jax.shard_map(local_qt, in_specs=(P(f.axis, None), P(f.axis)),
                          out_specs=P(f.axis))(f.qloc, v)  # (D*n,) stacked
    u = qt_apply(f.f2, w)                              # (D*n,) replicated
    v2 = jnp.sum(v * v)
    rest2 = jnp.maximum(v2 - jnp.sum(w * w), 0.0)
    out = jnp.zeros(m, v.dtype)
    out = out.at[:dn].set(u)
    out = out.at[dn].set(jnp.sqrt(rest2))
    return out
