"""Select-based single-index array updates (scatter-free).

WHY THIS EXISTS: ``x.at[i].set(v)`` with a *traced scalar* index lowers
to ``lax.scatter`` with ``indices_are_sorted=True`` / ``unique_indices=
True`` (trivially true for one index).  Under ``vmap`` JAX keeps those
flags and adds batching dims, and an XLA backend has been seen to
silently drop the update for batch rows >= 1024 whenever the per-lane
minor indices are not monotonic (found chasing a batched-solve
match-rate anomaly at B >= 2048 lanes; ``indices_are_sorted=False`` is
correct; gathers with the same flags are unaffected):

    out = jax.jit(jax.vmap(lambda m, g: m.at[g].set(False)))(mask, gidx)
    # rows >= 1024: update silently dropped for non-monotonic gidx

The helpers below express the same updates as ``jnp.where`` against an
iota, with no scatter op at all.  For the small/medium arrays the
solver touches a masked vector select is also cheaper than a scatter's
gather/update/write sequence, so it is used unconditionally rather
than gated on batch size.

Vector-index updates (``x.at[idx_vec].set``) lower with
``indices_are_sorted=False`` and are measured correct at B=4096; they
are left alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def set1(v: jax.Array, i: jax.Array, val) -> jax.Array:
    """``v.at[i].set(val)`` for a 1-D array and traced scalar ``i``."""
    return jnp.where(jnp.arange(v.shape[0]) == i, val, v)


def add1(v: jax.Array, i: jax.Array, val) -> jax.Array:
    """``v.at[i].add(val)`` for a 1-D array and traced scalar ``i``."""
    return v + jnp.where(jnp.arange(v.shape[0]) == i, val, jnp.zeros_like(v))


def set_col(A: jax.Array, k: jax.Array, col: jax.Array) -> jax.Array:
    """``A.at[:, k].set(col)`` for a 2-D array and traced scalar ``k``."""
    return jnp.where(jnp.arange(A.shape[1])[None, :] == k, col[:, None], A)


def set_row(A: jax.Array, i: jax.Array, row: jax.Array) -> jax.Array:
    """``A.at[i].set(row)`` for a 2-D array and traced scalar ``i``."""
    return jnp.where(jnp.arange(A.shape[0])[:, None] == i, row[None, :], A)


def set_col_dus(A: jax.Array, k: jax.Array, col: jax.Array) -> jax.Array:
    """``A.at[:, k].set(col)`` via ``dynamic_update_slice``.

    The where-based :func:`set_col` streams the WHOLE matrix per call —
    right for the small buffers the batched solver touches (and immune
    to the scatter miscompile above, which dus does not share: it is a
    different HLO op with no index-monotonicity flags).  For LARGE
    unbatched matrices (the geqp3 panel loop's 100 MB working sets) the
    full-matrix pass dominates the step cost; dus writes one column in
    place inside the loop carry."""
    k = jnp.asarray(k)
    return jax.lax.dynamic_update_slice(A, col[:, None],
                                        (jnp.zeros((), k.dtype), k))


def set_row_dus(A: jax.Array, i: jax.Array, row: jax.Array) -> jax.Array:
    """``A.at[i].set(row)`` via ``dynamic_update_slice`` (see
    :func:`set_col_dus`)."""
    i = jnp.asarray(i)
    return jax.lax.dynamic_update_slice(A, row[None, :],
                                        (i, jnp.zeros((), i.dtype)))
