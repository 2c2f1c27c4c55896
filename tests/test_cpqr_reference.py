"""Blocked CPQR paths against the unblocked reference ``ops.qr.cpqr``.

``cpqr_blocked`` (the dispatching entry) and the geqp3-style panel loop
``_cpqr_xla_panels`` must reproduce the plain pivoted QR's pivot order
and R factor, including when only the live columns are stepped.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from enlsip_tpu.ops.blocked_qr import _cpqr_xla_panels, cpqr_blocked, q_apply
from enlsip_tpu.ops.qr import cpqr


def _check(f, ref, M, k):
    np.testing.assert_array_equal(np.asarray(f.perm)[:k],
                                  np.asarray(ref.perm)[:k])
    np.testing.assert_allclose(np.asarray(f.R)[:k], np.asarray(ref.R)[:k],
                               atol=1e-10)
    rows, cols = M.shape
    R = np.zeros((rows, cols))
    R[:f.R.shape[0]] = np.asarray(f.R)
    Q = np.asarray(q_apply(f, jnp.eye(rows)))
    np.testing.assert_allclose(Q @ R, np.asarray(M)[:, np.asarray(f.perm)],
                               atol=1e-10)


@pytest.mark.parametrize("shape", [(16, 12), (33, 20), (24, 40)])
def test_blocked_and_panels_match_unblocked(shape):
    M = jnp.asarray(np.random.default_rng(0).normal(size=shape))
    ref = cpqr(M)
    k = min(shape)
    _check(cpqr_blocked(M), ref, M, k)
    _check(_cpqr_xla_panels(M, 8, None), ref, M, k)


def test_nsteps_over_live_columns_matches_unblocked():
    """Trailing zero columns: stepping only the live ones reproduces the
    unblocked factorization of the live part."""
    M = np.random.default_rng(1).normal(size=(20, 14))
    M[:, 9:] = 0.0
    M = jnp.asarray(M)
    ref = cpqr(M, nsteps=9)
    _check(cpqr_blocked(M, nsteps=jnp.int32(9)), ref, M, 9)
    _check(_cpqr_xla_panels(M, 8, jnp.int32(9)), ref, M, 9)
