"""Active-set factorizations, multiplier estimates and search directions.

Fixed-shape re-design of the reference's factorization chain
(/root/reference/src/enlsip_functions.jl):

* EVSCAL  (structures.jl:160-178)          -> :func:`gather_active`
* MULEST  (enlsip_functions.jl:461-508)    -> :func:`first_mult_estimate`
* LEAEST  (enlsip_functions.jl:514-537)    -> :func:`second_mult_estimate`
* SUBDIR  (enlsip_functions.jl:116-153)    -> :func:`sub_search_direction`
* GNSRCH  (enlsip_functions.jl:206-234)    -> :func:`gn_search_direction`
* NEWTON  (enlsip_functions.jl:348-423)    -> :func:`newton_search_direction`
  (HESSF/HESSH finite differences at :243-328 are replaced by exact AD
  Hessian contractions)

All matrices live in fixed max-size buffers; the working set enters as
gathered, masked rows; ranks/dims are traced int32.  Q factors stay
implicit: the blocked pivoted QR (ops/blocked_qr.py) returns compact-WY
reflectors, so J @ Q1, Q^T v and Q v are a couple of GEMMs each:
Q is never materialized.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..ops.blocked_qr import (CPQRF, cpqr_blocked, q_apply, qt_apply,
                              right_q_apply)
from ..ops.qr import invperm, pseudo_rank, solve_lower, solve_upper
from .types import Dims, WorkingView, rdims_or


class ActiveConstraint(NamedTuple):
    """Gathered (and optionally row-scaled) active-constraint data.

    Rows beyond ``t`` are zero.  Mirrors ``Constraint`` + EVSCAL
    (structures.jl:145-178)."""

    A_act: jax.Array       # (tmax, n)
    cx_act: jax.Array      # (tmax,)
    diag_scale: jax.Array  # (tmax,) row norms, or their inverses if scaling
    valid: jax.Array       # (tmax,) bool


class FactorA(NamedTuple):
    """Pivoted QR of the active-constraint transpose: A_act^T P = Q [R; 0].

    Reference: ``F_A = qr(C.A', ColumnNorm())`` (enlsip_functions.jl:700).
    ``f`` holds the compact-WY factors (Q implicit);
    ``qt_gf = Q^T grad_f`` is precomputed."""

    f: CPQRF           # R (tmax, tmax), V (n, tmax), T, perm, diag
    qt_gf: jax.Array   # (n,)

    @property
    def R(self):
        return self.f.R

    @property
    def perm(self):
        return self.f.perm

    @property
    def diag(self):
        return self.f.diag


class FactorL11(NamedTuple):
    """Pivoted QR of L11 = R_A^T (t x t): L11 P2 = Q2 [R11; 0].

    Reference: ``F_L11 = qr(F_A.R', ColumnNorm())`` (:724).
    ``qt_b = Q2^T (-cx_act[perm_A])`` is precomputed (the rhs used by
    every consumer: SUBDIR:142, ANALYS:1251, NEWTON:375)."""

    R: jax.Array      # (tmax, tmax)
    perm: jax.Array   # (tmax,)
    qt_b: jax.Array   # (tmax,)
    diag: jax.Array   # (tmax,)


class FactorJ2(NamedTuple):
    """Pivoted QR of J2 (the trailing n-rankA columns of J @ Q1), kept
    full-width: columns < rankA are zeroed and pivot last.

    Reference: ``F_J2 = qr(J2, ColumnNorm())`` (:223).  Q3 stays
    implicit; ``d = Q3^T (-J1 p1 - rx)`` is computed per-use with two
    small GEMVs (see :func:`j2_transform_d`)."""

    f: CPQRF           # R (min(m,n), n), V (m, min(m,n)), T, perm, diag

    @property
    def R(self):
        return self.f.R

    @property
    def perm(self):
        return self.f.perm

    @property
    def diag(self):
        return self.f.diag


def j2_transform_d(F_J2: "FactorJ2", JQ1: jax.Array, p1n: jax.Array,
                   rx: jax.Array) -> jax.Array:
    """d = Q3^T (-J1 p1 - rx) (J1 p1 == JQ1 @ p1n since p1n is zero
    past the leading slots).  Dispatches on the factorization kind:
    direct CPQR or the two-stage TSQR (giant-m row-sharded path)."""
    from ..ops.tsqr import (CholQRF, TSQRF, qt_apply_cholqr_from_projection,
                            qt_apply_tsqr)
    if isinstance(F_J2.f, CholQRF) and F_J2.f.G is not None:
        # Small-side algebra on the kept Gram (f.M is JQ1 on this
        # path): with v = -(JQ1 p1n) - rx,
        #   M^T v  = -(G p1n) - JQ1^T rx          ((n, n) matvec + ONE
        #                                           tall stream)
        #   ||v||^2 = p1n^T G p1n + 2 p1n^T (JQ1^T rx) + ||rx||^2
        # — the (m,) vector v is never materialized, saving two full
        # (m, n) streams per GN direction on giant-m AND keeping the
        # rare subspace branch free of (m, n)-broadcast operands (XLA
        # hoists those out of the cond; benchmarks/giant_m_profile.py).
        #
        # Cancellation envelope: reconstructing M^T v and
        # ||v||^2 from the Gram has absolute error ~eps*||JQ1||^2*
        # ||p1n|| instead of the materialized-v path's ~eps*||JQ1||*
        # ||v||.  When ||v|| << ||JQ1 p1n|| (near-exact GN steps on
        # zero-residual problems) the d-vector — including d1sq feeding
        # the +10000 convergence test and GNDCHK's ||d|| ratios —
        # becomes noise-dominated earlier than on the dense path.  In
        # that regime the noise EXIT tests (alfnoi/+40) absorb the
        # difference: the lane still terminates at the same iterate to
        # within the f32 envelope (the same adjudication as the CholQR
        # cond^2 caveat, ops/tsqr.py:162).  The same envelope applies
        # to the LEAEST rhs in second_mult_estimate, which rides this
        # Gram too.
        G = F_J2.f.G
        jtrx = F_J2.f.M.T @ rx                      # the one tall stream
        Gp = G @ p1n
        y = -Gp - jtrx
        v_sq = jnp.maximum(p1n @ Gp + 2.0 * (p1n @ jtrx) + jnp.dot(rx, rx),
                           0.0)
        return qt_apply_cholqr_from_projection(F_J2.f, y, v_sq)
    v = -(JQ1 @ p1n) - rx
    if isinstance(F_J2.f, TSQRF):
        return qt_apply_tsqr(F_J2.f, v)
    return qt_apply(F_J2.f, v)


class GNResult(NamedTuple):
    p: jax.Array       # (n,) search direction
    b: jax.Array       # (tmax,) rhs of the p1 system
    d: jax.Array       # (m,) rhs of the p2 system
    rankA: jax.Array
    rankJ2: jax.Array
    F_J2: FactorJ2
    JQ1: jax.Array     # (m, n)
    y: jax.Array       # (n,) pre-Q1 coefficients: p == Q1 @ y


def gather_active(A: jax.Array, cx: jax.Array, view: WorkingView, dims: Dims,
                  scaling: bool) -> ActiveConstraint:
    """Gather the active rows of A / entries of cx into fixed (tmax, ...)
    buffers and apply EVSCAL row scaling (structures.jl:160-178)."""
    tmax = dims.tmax
    eps = jnp.finfo(A.dtype).eps
    rows_idx = view.active_list[:tmax]
    valid = jnp.arange(tmax) < view.t
    A_act = jnp.where(valid[:, None], A[rows_idx], 0.0)
    cx_act = jnp.where(valid, cx[rows_idx], 0.0)
    row_nrm = jnp.sqrt(jnp.sum(A_act * A_act, axis=1))
    if scaling:
        safe = jnp.where(jnp.abs(row_nrm) < eps, 1.0, row_nrm)
        A_act = A_act / safe[:, None]
        cx_act = cx_act / safe
        diag_scale = 1.0 / safe
    else:
        diag_scale = row_nrm
    return ActiveConstraint(A_act, cx_act, diag_scale, valid)


def factor_active(act: ActiveConstraint, gf: jax.Array, t: jax.Array,
                  dims: Dims) -> FactorA:
    """F_A = blocked pivoted QR of A_act^T (t live columns);
    qt_gf = Q^T grad_f."""
    f = cpqr_blocked(act.A_act.T, nsteps=t)
    return FactorA(f=f, qt_gf=qt_apply(f, gf))


def zeros_factor_l11(dims: Dims, dtype) -> FactorL11:
    """Placeholder F_L11 for paths that never read it (full-rank GN):
    any consumer output fed by it is masked away before use."""
    ka, l = dims.ka, dims.l
    return FactorL11(R=jnp.zeros((ka, ka), dtype),
                     perm=jnp.arange(ka, dtype=jnp.int32),
                     qt_b=jnp.zeros((l,), dtype),
                     diag=jnp.zeros((ka,), dtype))


def factor_l11(F_A: FactorA, act: ActiveConstraint, t: jax.Array) -> FactorL11:
    """F_L11 = pivoted QR of L11 = R_A^T ((l, ka) buffer; rows beyond t
    are automatically zero because the masked slots of A pivot last);
    qt_b = Q2^T (-cx_act[perm_A])."""
    l = F_A.R.shape[1]
    ka = F_A.R.shape[0]
    i = jnp.arange(l)
    L11 = F_A.R.T                      # (l, ka)
    bvec = -jnp.where(i < t, act.cx_act[F_A.perm], 0.0)
    f = cpqr_blocked(L11, nsteps=jnp.minimum(t, ka))
    return FactorL11(R=f.R, perm=f.perm, qt_b=qt_apply(f, bvec), diag=f.diag)


def first_mult_estimate(F_A: FactorA, act: ActiveConstraint, t: jax.Array,
                        dims: Dims, scaling: bool, eps_rank: jax.Array
                        ) -> tuple[jax.Array, jax.Array]:
    """MULEST (enlsip_functions.jl:461-508).

    Returns (lam, grad_res): first-order Lagrange multipliers in active
    slot order (l buffer) and the projected-gradient residual norm
    ``||(Q^T grad_f)[prankA+1:n]||`` recorded into the iteration."""
    l, ka = dims.l, dims.ka
    prankA = pseudo_rank(F_A.diag, t, eps_rank)
    b = F_A.qt_gf  # (n,)
    v = solve_upper(F_A.R[:ka, :ka], b[:ka], prankA)
    ip = invperm(F_A.perm)
    lam_ls = jnp.zeros(l, b.dtype).at[:ka].set(v)[ip]
    idx_n = jnp.arange(dims.n)
    grad_res = jnp.sqrt(jnp.sum(jnp.where(idx_n >= prankA, b * b, 0.0)))
    b2 = -act.cx_act[F_A.perm]
    y = solve_lower(F_A.R.T[:ka, :ka], b2[:ka], prankA)
    u = solve_upper(F_A.R[:ka, :ka], y, prankA)
    lam = lam_ls + jnp.zeros(l, b.dtype).at[:ka].set(u)[ip]
    if scaling:
        lam = lam * act.diag_scale
    lam = jnp.where(act.valid, lam, 0.0)
    return lam, grad_res


def second_mult_estimate(F_A: FactorA, JQ1: jax.Array, rx: jax.Array,
                         J: jax.Array, p_gn: jax.Array, t: jax.Array,
                         act: ActiveConstraint, dims: Dims, scaling: bool,
                         F_J2: FactorJ2 | None = None,
                         y_gn: jax.Array | None = None,
                         jac_base=None) -> jax.Array:
    """LEAEST (enlsip_functions.jl:514-537): solve A^T lam = J1^T (rx + J p).

    Note the reference calls this with its *default* eps_rank = sqrt(eps)
    (:523), not the solver option; we reproduce that.  (Only called on
    the full-rank path, where t == rankA <= ka.)

    ``F_J2``/``y_gn``: optional GN products for the CholQR tall path —
    with p == Q1 y and the Gram G = JQ1^T JQ1 already held by the
    factorization, J1^T(rx + J p) == (JQ1^T rx + G y)[:t], turning the
    two (m, n)-buffer streams (J @ p and JQ1^T v) into one (the
    JQ1^T rx projection, CSE-shared with the d-vector's) plus an (n, n)
    matvec (benchmarks/giant_m_profile.py)."""
    from ..ops.tsqr import CholQRF
    l, ka = dims.l, dims.ka
    eps_rank = jnp.sqrt(jnp.finfo(rx.dtype).eps)
    prankA = pseudo_rank(F_A.diag, t, eps_rank)
    cols = jnp.arange(dims.n) < t
    if F_J2 is not None and y_gn is not None and \
            isinstance(F_J2.f, CholQRF) and F_J2.f.G is not None:
        b_raw = F_J2.f.M.T @ rx + F_J2.f.G @ y_gn
    else:
        # J1^T v with J1 = first t cols of JQ1: mask the (n,) RESULT,
        # not a materialized (n, m) operand copy (an (m, n) stream per
        # call on giant-m — see benchmarks/giant_m_profile.py).
        if jac_base is not None:  # factored J: J p = s * (base p)
            Jp_gn = J[:, 0] * (jac_base @ p_gn)
        else:
            Jp_gn = J @ p_gn
        b_raw = JQ1.T @ (rx + Jp_gn)
    b_full = jnp.where(cols, b_raw, 0.0)  # (n,)
    v = solve_upper(F_A.R[:ka, :ka], b_full[:ka], prankA)
    lam = jnp.zeros(l, rx.dtype).at[:ka].set(v)[invperm(F_A.perm)]
    if scaling:
        lam = lam * act.diag_scale
    return jnp.where(act.valid, lam, 0.0)


def _p1_stabilized(F_L11: FactorL11, dimA: jax.Array, rankA: jax.Array) -> jax.Array:
    """p1 for the rank-deficient path: solve R11[:dimA,:dimA] dp1 = qt_b,
    unpermute over the ka pivot slots, truncate to the first rankA
    entries (enlsip_functions.jl:141-144).  Returns a (ka,) vector."""
    ka = F_L11.R.shape[0]
    dp1 = solve_upper(F_L11.R[:ka, :ka], F_L11.qt_b[:ka], dimA)
    p1_full = jnp.zeros(ka, dp1.dtype).at[F_L11.perm].set(dp1)
    return jnp.where(jnp.arange(ka) < rankA, p1_full, 0.0)


def sub_search_direction(act: ActiveConstraint, rx: jax.Array, F_A: FactorA,
                         F_L11: FactorL11, F_J2: FactorJ2, JQ1: jax.Array,
                         t: jax.Array,
                         rankA: jax.Array, dimA: jax.Array, dimJ2: jax.Array,
                         code: jax.Array, dims: Dims
                         ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """SUBDIR (enlsip_functions.jl:116-153), full-width formulation.

    code == 1: p1 = L11^-1 (-cx[P1])            (full-rank A)
    code == -1: stabilized p1 through F_L11      (rank-deficient A)
    then d = Q3^T (-J1 p1 - rx), p2 from dimJ2 columns of R22,
    p = Q1 (p1 ++ p2).

    Both branches are computed and selected (cheap triangular solves),
    which keeps this usable inside vmapped lanes without cond overhead.
    """
    n, ka = dims.n, dims.ka
    bvec = -act.cx_act[F_A.perm]
    # Full-rank branch only valid when t <= ka (code 1 implies it);
    # the solve is clamped so the unselected branch stays finite.
    p1_full = solve_lower(F_A.R.T[:ka, :ka], bvec[:ka], jnp.minimum(t, ka))
    p1_stab = _p1_stabilized(F_L11, dimA, rankA)
    use_full = code == 1
    p1 = jnp.where(use_full, p1_full, p1_stab)   # (ka,)
    b = jnp.where(use_full, bvec, F_L11.qt_b)    # (l,)
    # Embed p1 into y-coordinates (first rankA slots; rankA == t if code 1).
    p1n = jnp.zeros(n, rx.dtype).at[:ka].set(p1)
    d = j2_transform_d(F_J2, JQ1, p1n, rx)     # (m,)
    kk = min(dims.m, n)
    dp2 = solve_upper(F_J2.R[:, :kk], d[:kk], dimJ2)  # (kk,)
    p2n = jnp.zeros(n, rx.dtype).at[F_J2.perm[:kk]].set(dp2)
    y = p1n + p2n
    p = q_apply(F_A.f, y)
    return p, b, d, y


def gn_search_direction(J: jax.Array, rx: jax.Array, act: ActiveConstraint,
                        F_A: FactorA, F_L11: FactorL11, rankA: jax.Array,
                        t: jax.Array, eps_rank: jax.Array, dims: Dims,
                        rdims=None, tsqr_axis=None,
                        tall_qr: str = "cholqr", jac_base=None) -> GNResult:
    """GNSRCH (enlsip_functions.jl:206-234).

    ``jac_base`` (factored-Jacobian mode, Functions.jac_rowscale/
    jac_base): ``J`` then holds the (m, 1) row scale and the semantic
    Jacobian is diag(J[:, 0]) @ jac_base; the WY apply runs on the
    base and the scale is applied to its result, so the dense J is
    never formed."""
    n = dims.n
    rd = rdims_or(rdims, dims)
    rows = jac_base.shape[0] if jac_base is not None else J.shape[0]
    cols = jnp.arange(n)
    live_cols = cols >= rankA
    tall = rows >= 32 * n and rows >= 4096
    if jac_base is not None:
        # (m, 1) scale broadcasts over the applied base.
        JQ1 = J * right_q_apply(F_A.f, jac_base)
    else:
        JQ1 = right_q_apply(F_A.f, J)
    # Only n - rankA columns are live; skip the no-op steps.
    if tsqr_axis is not None or tall:
        # Tall panel (giant-m; one device or row-sharded): a two-stage
        # factorization replaces the n-step pivot loop that would
        # stream the full (m, n) buffer each step.  Column norms (hence
        # pivoting and rank decisions) are preserved by both stages.
        if tall_qr == "cholqr":
            # GEMM-speed Gram + shifted Cholesky, implicit Q; sharded
            # rows contract through ONE (n, n) psum (ops/tsqr.CholQRF).
            # JQ1 is passed UNMASKED; dead columns are zeroed on the
            # (n, n) Gram instead (bitwise identical, saves a full
            # (m, n) masked-copy round trip per factorization).
            from ..ops.tsqr import cholqr_cpqr
            F_J2 = FactorJ2(f=cholqr_cpqr(JQ1, nsteps=n - rankA,
                                          col_live=live_cols))
        else:
            J2buf = jnp.where(live_cols[None, :], JQ1, 0.0)
            # Householder first stage: local/whole thin QR + pivoted QR
            # of the stacked R factors.
            from ..ops.tsqr import tsqr_cpqr
            F_J2 = FactorJ2(f=tsqr_cpqr(J2buf, nsteps=n - rankA,
                                        axis=tsqr_axis))
    else:
        J2buf = jnp.where(live_cols[None, :], JQ1, 0.0)
        F_J2 = FactorJ2(f=cpqr_blocked(J2buf, nsteps=n - rankA))
    # Semantic diag length (pseudo_rank's sqrt(len) tolerance factor
    # must see the lane's true dimensions; padded columns have zero
    # diag and never count anyway).
    len_diag = jnp.minimum(rd.m, rd.n - rankA)
    rankJ2 = pseudo_rank(F_J2.diag, len_diag, eps_rank)
    code = jnp.where(rankA == t, 1, -1).astype(jnp.int32)
    p, b, d, y = sub_search_direction(act, rx, F_A, F_L11, F_J2, JQ1, t,
                                      rankA, rankA, rankJ2, code, dims)
    return GNResult(p=p, b=b, d=d, rankA=rankA, rankJ2=rankJ2, F_J2=F_J2,
                    JQ1=JQ1, y=y)


def hessian_contractions(res_fn: Callable, cons_fn: Callable, x: jax.Array,
                         rx: jax.Array, lam_full: jax.Array
                         ) -> tuple[jax.Array, jax.Array]:
    """Exact AD replacements for HESSF/HESSH (enlsip_functions.jl:243-328).

    r_mat = sum_k r_k(x0) * hess(r_k)(x)   = hess_x <r(x), rx_const>
    c_mat = sum_i lam_i   * hess(c_i)(x)   = hess_x <c(x), lam_full>

    The reference computes these by O(n^2) central finite differences of
    the user functions; nested forward-over-reverse AD is both exact
    and far cheaper on an accelerator.
    """
    rxc = jax.lax.stop_gradient(rx)
    lamc = jax.lax.stop_gradient(lam_full)
    r_mat = jax.hessian(lambda z: jnp.vdot(res_fn(z), rxc))(x)
    c_mat = jax.hessian(lambda z: jnp.vdot(cons_fn(z), lamc))(x)
    return r_mat, c_mat


def newton_search_direction(res_fn: Callable, cons_fn: Callable, x: jax.Array,
                            rx: jax.Array, lam: jax.Array, view: WorkingView,
                            act: ActiveConstraint, F_A: FactorA,
                            F_L11: FactorL11, JQ1: jax.Array, rankA: jax.Array,
                            t: jax.Array, dims: Dims, rdims=None
                            ) -> tuple[jax.Array, jax.Array]:
    """NEWTON (enlsip_functions.jl:348-423): KKT step on the null-space
    system with exact second-order terms.  Returns (p, error) where
    error mirrors the Cholesky-failure flag (-> exit code -3).

    Deviation noted for parity auditing: when t > rankA the reference
    permutes E by F_L11.p in a way that would index out of bounds for
    n > t (:395-399); we apply the intended permutation on the leading
    t coordinates and identity elsewhere."""
    n, ka, l = dims.n, dims.ka, dims.l
    n_sem = rdims_or(rdims, dims).n
    bvec = -act.cx_act[F_A.perm]
    p1_full = solve_lower(F_A.R.T[:ka, :ka], bvec[:ka], jnp.minimum(t, ka))
    p1_stab = _p1_stabilized(F_L11, rankA, rankA)
    p1 = jnp.where(t == rankA, p1_full, p1_stab)
    p1n = jnp.zeros(n, x.dtype).at[:ka].set(p1)

    # Scatter slot multipliers to the full constraint vector.
    lam_full = jnp.zeros(l, x.dtype).at[view.active_list].set(
        jnp.where(act.valid, lam, 0.0))
    r_mat, c_mat = hessian_contractions(res_fn, cons_fn, x, rx, lam_full)
    Gamma = r_mat - c_mat
    E = right_q_apply(F_A.f, qt_apply(F_A.f, Gamma))
    # Permute leading-t coordinates by F_L11.p when t > rankA (:396-399).
    idn = jnp.arange(n, dtype=jnp.int32)
    permf = jnp.where(idn < ka,
                      jnp.pad(F_L11.perm, (0, n - ka) if n > ka else (0, 0))[:n],
                      idn)
    permf = jnp.where(jnp.arange(n) < t, permf, idn)
    Ep = E[permf][:, permf]
    E_used = jnp.where(t > rankA, Ep, E)

    cols = jnp.arange(n)
    # Padded coordinates (>= the lane's true n) are outside the Newton
    # block: Gamma and J2 are exactly zero there, so including them
    # would make W singular; excluded they sit on the identity part of
    # Wm and get p2 = 0, exactly like the < rankA coordinates.
    in2 = (cols >= rankA) & (cols < n_sem)
    J2 = jnp.where(in2[None, :], JQ1, 0.0)  # (m, n) live cols >= rankA
    W = E_used + J2.T @ J2                  # W22 on the (>=rankA) block
    W21p1 = E_used @ p1n + J2.T @ (JQ1 @ p1n)
    dfull = jnp.where(in2, -(W21p1) - J2.T @ rx, 0.0)

    sW = 0.5 * (W + W.T)
    blk = in2[:, None] & in2[None, :]
    Wm = jnp.where(blk, sW, jnp.eye(n, dtype=x.dtype))
    L = jnp.linalg.cholesky(Wm)
    bad = jnp.any(jnp.isnan(L))
    Ls = jnp.where(jnp.isnan(L), jnp.eye(n, dtype=x.dtype), L)
    y = jax.scipy.linalg.solve_triangular(Ls, dfull, lower=True)
    p2n = jax.scipy.linalg.solve_triangular(Ls.T, y, lower=False)
    p2n = jnp.where(in2, p2n, 0.0)
    p = q_apply(F_A.f, p1n + p2n)
    p = jnp.where(bad, jnp.zeros_like(p), p)
    # rankA == n: constraints determine the step fully (:379-381).
    p = jnp.where(rankA >= n_sem, q_apply(F_A.f, p1n), p)
    error = bad & (rankA < n_sem)
    return p, error
