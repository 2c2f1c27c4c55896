"""Fixed-shape masked dense linear algebra for the ENLSIP core.

The reference solver (Enlsip.jl) leans on LAPACK's column-pivoted
Householder QR (``qr(Â, ColumnNorm())``, see
/root/reference/src/enlsip_functions.jl:700,223,724) and on
triangular solves with *data-dependent* truncation dimensions
(``UpperTriangular(R[1:k,1:k]) \\ b[1:k]``, e.g. :136,:143,:480).

Under jit/vmap every shape must be static, so this module provides:

* :func:`cpqr` — column-pivoted Householder QR on a fixed-size buffer
  whose invalid trailing columns are zero.  Zero columns have zero
  norms, are pivoted last and produce ``tau = 0`` no-op reflectors, so
  the factorization of the "live" submatrix is exactly the pivoted QR
  the reference computes.  Extra *augmented* columns ride along and
  receive every reflector, which yields ``Q**T @ aug`` as a byproduct —
  this replaces all of the reference's explicit ``F.Q' * v`` products
  (and, with an identity block, materializes ``Q`` itself) without a
  sequential apply pass.
* masked triangular solves where only the leading ``k x k`` block
  participates (``k`` traced), the rest of the solution being zero.
* :func:`pseudo_rank` — the reference's diagonal-based numerical rank
  (enlsip_functions.jl:17-31) with a traced diagonal length, including
  the deliberate ``sqrt(len)`` tolerance factor.

Everything is pure, fixed-shape, and vmap/jit friendly.  The
factorization is a ``lax.fori_loop`` of rank-1 updates (elementwise
work); under ``vmap`` the batch dimension is the wide axis, which is the
intended high-throughput regime.  The big GEMMs (``J @ Q``) happen
outside.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .select_update import set1, set_col


class CPQR(NamedTuple):
    """Column-pivoted QR of a masked buffer ``M`` (rows x cols).

    ``M[:, perm] = Q @ R`` restricted to the ``ncols`` live columns.

    Attributes:
      R: (kmax, cols) upper-trapezoidal factor (kmax = min(rows, cols)).
      perm: (cols,) int32 pivot permutation, ``R``'s column j corresponds
        to original column ``perm[j]``.
      qt_aug: (rows, naug) the augmented columns with every reflector
        applied, i.e. ``Q**T @ aug``.  ``None`` when no aug was passed.
      diag: (kmax,) the diagonal of R (convenience for pseudo_rank).
    """

    R: jax.Array
    perm: jax.Array
    qt_aug: jax.Array | None
    diag: jax.Array


def _householder(col: jax.Array, k: int | jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Householder reflector annihilating ``col[k+1:]`` (entries < k ignored).

    Returns (v, tau, beta) with H = I - tau v v**T, H @ col = beta e_k
    on the active part.  Safe for zero columns (tau = 0).
    """
    rows = col.shape[0]
    idx = jnp.arange(rows)
    tail = jnp.where(idx >= k, col, 0.0)
    alpha = col[k] if isinstance(k, int) else jnp.take(col, k)
    signorm = jnp.sqrt(jnp.sum(tail * tail))
    # LAPACK sign convention: beta = -sign(alpha) * ||tail||
    sign = jnp.where(alpha >= 0, 1.0, -1.0)
    beta = -sign * signorm
    denom = alpha - beta
    safe = jnp.abs(denom) > 0
    denom = jnp.where(safe, denom, 1.0)
    v = jnp.where(idx > k, tail / denom, 0.0)
    v = set1(v, k, jnp.where(safe, 1.0, 0.0))
    # tau = (beta - alpha)/beta for the normalized (v_k = 1) convention.
    tau = jnp.where(safe & (beta != 0), (beta - alpha) / jnp.where(beta != 0, beta, 1.0), 0.0)
    return v, tau, jnp.where(safe, beta, alpha)


def cpqr(M: jax.Array, aug: jax.Array | None = None, *, nsteps: int | None = None) -> CPQR:
    """Column-pivoted Householder QR of a fixed-shape buffer.

    Invalid columns of ``M`` must be zeroed by the caller; pivoting on
    column norms then automatically orders them last.  ``aug`` columns
    are not pivoted and not factored; they receive every reflector
    (producing ``Q**T @ aug``).

    Mirrors the role of Julia ``qr(A, ColumnNorm())`` in the reference
    (enlsip_functions.jl:700, :223, :724) for masked fixed shapes.
    """
    rows, cols = M.shape
    kmax = min(rows, cols) if nsteps is None else nsteps
    perm0 = jnp.arange(cols, dtype=jnp.int32)
    if aug is None:
        augbuf = jnp.zeros((rows, 1), dtype=M.dtype)
    else:
        augbuf = aug

    def body(k, carry):
        A, G, perm = carry
        # Column norms of the unfactored block (rows >= k), masked to
        # unpivoted columns (positions >= k).
        ridx = jnp.arange(rows)
        cidx = jnp.arange(cols)
        sub = jnp.where(ridx[:, None] >= k, A, 0.0)
        nrm2 = jnp.sum(sub * sub, axis=0)
        nrm2 = jnp.where(cidx >= k, nrm2, -1.0)
        piv = jnp.argmax(nrm2).astype(jnp.int32)
        # Swap columns k <-> piv (and perm entries).
        colk = A[:, k]
        colp = jnp.take(A, piv, axis=1)
        A = set_col(A, k, colp)
        A = set_col(A, piv, jnp.where(piv == k, colp, colk))
        pk = perm[k]
        pp = jnp.take(perm, piv)
        perm = set1(perm, k, pp)
        perm = set1(perm, piv, jnp.where(piv == k, pp, pk))
        # Householder on column k.
        v, tau, _ = _householder(A[:, k], k)
        # Apply H = I - tau v v^T to A[:, k:] and to G.
        vtA = v @ A  # (cols,)
        A = A - tau * jnp.outer(v, vtA)
        vtG = v @ G
        G = G - tau * jnp.outer(v, vtG)
        # Clean exact zeros below the diagonal in column k.
        A = set_col(A, k, jnp.where(ridx > k, 0.0, A[:, k]))
        return A, G, perm

    A, G, perm = lax.fori_loop(0, kmax, body, (M, augbuf, perm0))
    R = A[:kmax, :]
    diag = jnp.diagonal(R)[:kmax]
    return CPQR(R=R, perm=perm, qt_aug=(None if aug is None else G), diag=diag)


def pseudo_rank(diag: jax.Array, length: jax.Array, eps_rank: jax.Array) -> jax.Array:
    """Numerical rank from a pivoted triangular diagonal.

    Reference: enlsip_functions.jl:17-31 (including the deliberate
    ``sqrt(length)`` factor noted in review_report.tex §D1): with
    ``tol = |d_0| * sqrt(length) * eps_rank``, the rank is the length of
    the leading run of entries with ``|d_i| > tol``; 0 if the diagonal
    is empty or ``|d_0| < eps_rank``.

    Args:
      diag: (k,) diagonal buffer (entries >= length are ignored).
      length: traced number of valid diagonal entries.
    """
    k = diag.shape[0]
    idx = jnp.arange(k)
    d0 = jnp.abs(diag[0]) if k > 0 else jnp.asarray(0.0, diag.dtype)
    flen = jnp.maximum(length, 1).astype(diag.dtype)
    tol = d0 * jnp.sqrt(flen) * eps_rank
    ok = (jnp.abs(diag) > tol) & (idx < length)
    run = jnp.cumprod(ok.astype(jnp.int32))
    r = jnp.sum(run)
    return jnp.where((length <= 0) | (d0 < eps_rank), 0, r).astype(jnp.int32)


def _masked_tri(Rk: jax.Array, k: jax.Array, lower: bool) -> jax.Array:
    """Doctor R so only its leading k x k block participates in a solve.

    Entries outside the block become the identity, so the solution's
    trailing entries equal the (zero-masked) rhs there.
    """
    c = Rk.shape[0]
    i = jnp.arange(c)
    inblk = (i[:, None] < k) & (i[None, :] < k)
    eye = jnp.eye(c, dtype=Rk.dtype)
    return jnp.where(inblk, Rk, eye)


def solve_upper(R: jax.Array, b: jax.Array, k: jax.Array) -> jax.Array:
    """x[:k] = R[:k,:k]^-1 b[:k]; x[k:] = 0.  (Reference pattern
    ``UpperTriangular(R[1:k,1:k]) \\ b[1:k]``.)"""
    c = R.shape[0]
    i = jnp.arange(c)
    Rm = _masked_tri(R[:, :c], k, lower=False)
    bm = jnp.where(i < k, b[:c], 0.0)
    x = jax.scipy.linalg.solve_triangular(Rm, bm, lower=False)
    return jnp.where(i < k, x, 0.0)


def solve_lower(L: jax.Array, b: jax.Array, k: jax.Array) -> jax.Array:
    """x[:k] = L[:k,:k]^-1 b[:k]; x[k:] = 0 (forward substitution)."""
    c = L.shape[0]
    i = jnp.arange(c)
    Lm = _masked_tri(L[:, :c], k, lower=True)
    bm = jnp.where(i < k, b[:c], 0.0)
    x = jax.scipy.linalg.solve_triangular(Lm, bm, lower=True)
    return jnp.where(i < k, x, 0.0)


def invperm(perm: jax.Array) -> jax.Array:
    """Inverse permutation: out[perm[i]] = i."""
    n = perm.shape[0]
    return jnp.zeros(n, dtype=perm.dtype).at[perm].set(jnp.arange(n, dtype=perm.dtype))


def prefix_norm(v: jax.Array, k: jax.Array) -> jax.Array:
    """||v[:k]|| with traced k (clamped to [0, len(v)])."""
    idx = jnp.arange(v.shape[0])
    return jnp.sqrt(jnp.sum(jnp.where(idx < k, v * v, 0.0)))


def prefix_dot(v: jax.Array, k: jax.Array) -> jax.Array:
    """<v[:k], v[:k]> with traced k."""
    idx = jnp.arange(v.shape[0])
    return jnp.sum(jnp.where(idx < k, v * v, 0.0))
