"""Fused batched CPQR: one Pallas (Triton) program factorizes a block of lanes.

The batched solver's hot factorization is thousands of tiny masked
pivoted QRs (HS-suite shapes: rows, cols <= ~16) under ``vmap``.  As an
XLA loop each of the kmax Householder steps is ~20 small kernels over a
(B, rows, cols) buffer, and the sequential ``fori_loop`` prevents
cross-step fusion, so the loop is bound by kernel launches rather than
by memory or arithmetic.

This kernel runs the ENTIRE factorization of a block of ``LB`` lanes in
one program, in structure-of-arrays layout ``(cols, rows, lanes)``: the
batch is the contiguous (last) axis, so consecutive lanes map onto
consecutive threads of a warp and every load and store coalesces.
Rows and columns are padded inside the program to powers of two by
masked loads (Triton's tensors have power-of-two shapes); padded
entries are zero, pivot last and never reach the outputs.  Columns are
extracted by one-hot reductions, because Triton cannot slice register
tensors.  The kernel has no dot products: every operation is an
elementwise IEEE f32 multiply, add or reduction, so its precision does
not depend on the ambient matmul setting (no TF32 path exists).
Reflector tails are packed below the diagonal LAPACK-style,
so the caller rebuilds the same compact-WY
:class:`~enlsip_tpu.ops.blocked_qr.CPQRF` the XLA path returns (same
pivot tie-breaking, sign convention, tau = 0 no-op reflectors for zero
columns), up to f32 reduction-order rounding.

Reference role: the batched equivalent of LAPACK ``geqp3``
(``qr(A', ColumnNorm())``, enlsip_functions.jl:700) for scenario
batches, a regime the single-instance reference never had.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Elements of the (cols, rows, lanes) tile one program keeps in
# registers; the lane block is the largest power of two that fits.
TILE_ELEMS = 4096
# Lane-block bounds and the number of programs the batch is split into
# before the block grows (enough blocks in flight to fill every SM).
MIN_LANE_BLOCK = 8
MAX_LANE_BLOCK = 256
TARGET_PROGRAMS = 512

# Static gates for the kernel path, set from timings on an H100 (B=4096,
# kernel vs the vmapped XLA loop): the kernel is faster at every shape
# up to 16 x 32 and slower at 32 x 32, where each program's tile of a
# few lanes leaves the card underused.
MAX_KMAX = 16
MAX_ELEMS = 16 * 32


def _pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def lane_block(rows: int, cols: int, batch: int) -> int:
    """Lanes per program for a (rows, cols) shape and batch size."""
    fit = TILE_ELEMS // (_pow2(rows) * _pow2(cols))
    fit = max(1, 1 << (max(fit, 1).bit_length() - 1))     # pow2 floor
    want = _pow2(-(-batch // TARGET_PROGRAMS))
    return max(1, min(fit, MAX_LANE_BLOCK, max(MIN_LANE_BLOCK, want)))


def _kernel(a_ref, r_ref, tau_ref, perm_ref, *, batch, rows, cols, lb):
    """Factorize lanes [pid * lb, pid * lb + lb) of the batch.

    a_ref: (cols, rows, batch) input, lane b's matrix is a[:, :, b].T.
    r_ref: (cols, rows, batch) packed output (R in the upper triangle
      read matrix-wise, reflector tails below the diagonal).
    tau_ref: (kmax, batch); perm_ref: (cols, batch) int32.
    """
    kmax = min(rows, cols)
    C, R, K = _pow2(cols), _pow2(rows), _pow2(kmax)
    lane = pl.program_id(0) * lb + jnp.arange(lb)
    live = lane < batch
    c3 = lax.broadcasted_iota(jnp.int32, (C, R, lb), 0)
    r3 = lax.broadcasted_iota(jnp.int32, (C, R, lb), 1)
    c2 = lax.broadcasted_iota(jnp.int32, (C, lb), 0)
    r2 = lax.broadcasted_iota(jnp.int32, (R, lb), 0)
    k2 = lax.broadcasted_iota(jnp.int32, (K, lb), 0)
    in3 = (c3 < cols) & (r3 < rows) & live[None, None, :]
    A = plgpu.load(a_ref.at[c3, r3, lane[None, None, :]], mask=in3,
                   other=0.0)
    zero = jnp.zeros((), A.dtype)

    def step(k, carry):
        A, perm, taus = carry
        # ---- trailing column norms + first-max pivot per lane --------
        # (columns < k hold packed reflector tails below the diagonal;
        # they are excluded from the pivot search by the column mask)
        sub = jnp.where(r3 >= k, A, zero)
        nrm2 = jnp.sum(sub * sub, axis=1)                       # (C, lb)
        nrm2 = jnp.where(c2 >= k, nrm2, -1.0)
        mx = jnp.max(nrm2, axis=0)                              # (lb,)
        piv = jnp.min(jnp.where(nrm2 == mx[None, :], c2, C), axis=0)
        onehot2 = c2 == piv[None, :]                            # (C, lb)
        onehot3 = c3 == piv[None, None, :]
        is_k2, is_k3 = c2 == k, c3 == k
        # ---- swap matrix columns k <-> piv (per lane) ----------------
        colp = jnp.sum(jnp.where(onehot3, A, zero), axis=0)     # (R, lb)
        colk = jnp.sum(jnp.where(is_k3, A, zero), axis=0)
        A = jnp.where(is_k3, colp[None],
                      jnp.where(onehot3, colk[None], A))
        pk = jnp.max(jnp.where(is_k2, perm, -1), axis=0)
        pp = jnp.max(jnp.where(onehot2, perm, -1), axis=0)
        perm = jnp.where(is_k2, pp[None, :],
                         jnp.where(onehot2, pk[None, :], perm))
        # ---- Householder reflector on column k -----------------------
        tail = jnp.where(r2 >= k, colp, zero)
        alpha = jnp.sum(jnp.where(r2 == k, colp, zero), axis=0)  # (lb,)
        signorm = jnp.sqrt(jnp.sum(tail * tail, axis=0))
        beta = jnp.where(alpha >= 0, -signorm, signorm)
        denom = alpha - beta
        safe = jnp.abs(denom) > 0
        denom = jnp.where(safe, denom, 1.0)
        v = jnp.where(r2 > k, tail / denom[None, :], zero)
        v = jnp.where(r2 == k, jnp.where(safe, 1.0, 0.0)[None, :], v)
        tau = jnp.where(safe & (beta != 0),
                        (beta - alpha) / jnp.where(beta != 0, beta, 1.0),
                        zero)                                   # (lb,)
        taus = jnp.where(k2 == k, tau[None, :], taus)
        # ---- apply H = I - tau v v^T to the trailing columns ---------
        vtA = jnp.sum(v[None] * A, axis=1)                      # (C, lb)
        vtA = jnp.where(c2 > k, vtA, zero) * tau[None, :]
        A = A - v[None] * vtA[:, None, :]
        # ---- column k: R above, beta on the diagonal, packed reflector
        # tail below (rows < k untouched by H since v vanishes there) --
        newcol = jnp.where(r2 == k, jnp.where(safe, beta, alpha)[None, :],
                           jnp.where(r2 < k, colp, v))
        A = jnp.where(is_k3, newcol[None], A)
        return A, perm, taus

    A, perm, taus = lax.fori_loop(
        0, kmax, step, (A, c2, jnp.zeros((K, lb), A.dtype)))
    plgpu.store(r_ref.at[c3, r3, lane[None, None, :]], A, mask=in3)
    plgpu.store(tau_ref.at[k2, lane[None, :]], taus,
                mask=(k2 < kmax) & live[None, :])
    plgpu.store(perm_ref.at[c2, lane[None, :]], perm,
                mask=(c2 < cols) & live[None, :])


def cpqr_batched_packed(M: jax.Array, *, interpret: bool = False):
    """Batched CPQR of AoS buffers ``M`` (B, rows, cols).

    Returns (packed (B, rows, cols), tau (B, kmax), perm (B, cols) i32):
    R in packed's upper triangle, unit-lower reflector tails below.
    """
    B, rows, cols = M.shape
    kmax = min(rows, cols)
    lb = lane_block(rows, cols, B)
    elems = _pow2(rows) * _pow2(cols) * lb
    At = jnp.transpose(M, (2, 1, 0))                       # (cols, rows, B)
    packed_t, tau_t, perm_t = pl.pallas_call(
        functools.partial(_kernel, batch=B, rows=rows, cols=cols, lb=lb),
        grid=(-(-B // lb),),
        out_shape=(jax.ShapeDtypeStruct((cols, rows, B), M.dtype),
                   jax.ShapeDtypeStruct((kmax, B), M.dtype),
                   jax.ShapeDtypeStruct((cols, B), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(8, elems // 512)), num_stages=1),
        interpret=interpret,
        name="cpqr_batched",
    )(At)
    return (jnp.transpose(packed_t, (2, 1, 0)), tau_t.T, perm_t.T)


def cpqr_blocked_batched(M: jax.Array, *, interpret: bool = False):
    """Batched :class:`~enlsip_tpu.ops.blocked_qr.CPQRF` (leading B axis)
    via the fused kernel, drop-in for ``jax.vmap(cpqr_blocked)``."""
    from .blocked_qr import CPQRF, _panel_T
    B, rows, cols = M.shape
    kmax = min(rows, cols)
    packed, tau, perm = cpqr_batched_packed(M, interpret=interpret)
    ridx = jnp.arange(rows)[None, :, None]
    kcol = jnp.arange(kmax)[None, None, :]
    Bk = packed[:, :, :kmax]
    V = jnp.where(ridx > kcol, Bk, 0.0)
    V = V + jnp.where((ridx == kcol) & (tau[:, None, :] > 0), 1.0, 0.0)
    R = jnp.triu(packed[:, :kmax, :])
    # Single WY panel: nb == kmax (the gate keeps kmax <= 16 << NB).
    T = jax.vmap(lambda v, t: _panel_T(v, t, kmax))(V, tau)
    diag = jnp.diagonal(R, axis1=1, axis2=2)
    return CPQRF(R=R, perm=perm, V=V, tau=tau, T=T, diag=diag)
