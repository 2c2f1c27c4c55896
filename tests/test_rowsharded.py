"""Giant-m row-sharded solve: must compile over an 8-device mesh and
match the dense single-device solution."""

import jax
import jax.numpy as jnp
import numpy as np

import enlsip_tpu as et
from enlsip_tpu.core.driver import Functions
from enlsip_tpu.core.types import Dims, Options, Tols
from enlsip_tpu.parallel.rowsharded import row_mesh, solve_rowsharded

N, M, L = 8, 512, 4
_rng = np.random.default_rng(0)
_T = np.linspace(0.0, 1.0, M)
_W = _rng.normal(size=(M, N)) / np.sqrt(N)
_Y = np.sin(3 * _T) + 0.1 * _rng.normal(size=M)


def _residuals(x):
    # data-fit residuals with a mild nonlinearity
    z = jnp.asarray(_W) @ x
    return jnp.asarray(_Y) - (z + 0.1 * jnp.tanh(z))


def _ineq(x):
    # simple smooth inequality constraints + norm cap
    return jnp.concatenate([x[:L - 1] + 1.0,
                            jnp.array([4.0 - jnp.dot(x, x)])])


def _setup():
    fns = Functions(res=_residuals, jac_res=jax.jacfwd(_residuals),
                    cons=_ineq, jac_cons=jax.jacfwd(_ineq))
    dims = Dims(n=N, m=M, q=0, l=L)
    opts = Options(second_derivatives=False, max_iter=30)
    eps = float(jnp.finfo(jnp.float64).eps)
    rel = float(np.sqrt(eps))
    tols = Tols(*(jnp.float64(v) for v in (1e-10, rel, rel, rel, rel)))
    return fns, dims, opts, tols


def test_rowsharded_matches_dense(eight_devices):
    fns, dims, opts, tols = _setup()
    x0 = jnp.zeros(N, jnp.float64)
    dense = et.core_solve(fns, x0, dims, opts, tols)
    assert dense.exit_code > 0

    mesh = row_mesh(eight_devices)
    carry = solve_rowsharded(fns, x0, dims, opts, tols, mesh=mesh)
    assert int(carry.exit_code) > 0
    np.testing.assert_allclose(np.asarray(carry.x), np.asarray(dense.x),
                               atol=1e-9)
    assert int(carry.nb_iter) == dense.n_iter

def test_rowsharded_tsqr_matches_dense(eight_devices):
    # The TSQR reduction path (ops/tsqr.py): same solution, same
    # iteration count as the dense and GSPMD-pivot-loop paths.
    fns, dims, opts, tols = _setup()
    x0 = jnp.zeros(N, jnp.float64)
    dense = et.core_solve(fns, x0, dims, opts, tols)

    mesh = row_mesh(eight_devices)
    carry = solve_rowsharded(fns, x0, dims, opts, tols, mesh=mesh,
                             tsqr=True)
    assert int(carry.exit_code) > 0
    np.testing.assert_allclose(np.asarray(carry.x), np.asarray(dense.x),
                               atol=1e-9)
    assert int(carry.nb_iter) == dense.n_iter


def test_tsqr_factorization_matches_direct(eight_devices):
    # R/perm/diag of the two-stage factorization match the direct CPQR
    # up to row signs; Q^T v agrees on the leading entries and in norm.
    from enlsip_tpu.ops.blocked_qr import cpqr_blocked, qt_apply
    from enlsip_tpu.ops.tsqr import tsqr_cpqr, qt_apply_tsqr
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(1)
    m, n = 256, 8
    M = jnp.asarray(rng.normal(size=(m, n)))
    v = jnp.asarray(rng.normal(size=(m,)))
    mesh = row_mesh(eight_devices)

    direct = cpqr_blocked(M, nsteps=jnp.int32(n))
    with jax.set_mesh(mesh):
        Ms = jax.device_put(M, NamedSharding(mesh, P("rows", None)))
        vs = jax.device_put(v, NamedSharding(mesh, P("rows")))
        f = jax.jit(lambda M: tsqr_cpqr(M, jnp.int32(n), "rows"))(Ms)
        d = jax.jit(qt_apply_tsqr)(f, vs)
        d_direct = qt_apply(direct.f if hasattr(direct, "f") else direct, v)

    np.testing.assert_array_equal(np.asarray(f.perm), np.asarray(direct.perm))
    np.testing.assert_allclose(np.abs(np.asarray(f.R)),
                               np.abs(np.asarray(direct.R)), atol=1e-10)
    np.testing.assert_allclose(np.abs(np.asarray(d[:n])),
                               np.abs(np.asarray(d_direct[:n])), atol=1e-10)
    np.testing.assert_allclose(float(jnp.sum(d * d)), float(jnp.dot(v, v)),
                               rtol=1e-12)


def test_rowsharded_data_argument_matches_closure(eight_devices):
    """Problem arrays passed as ``data`` (jit arguments, rows sharded)
    give the closure-captured solve's result."""
    fns, dims, opts, tols = _setup()
    x0 = jnp.zeros(N, jnp.float64)
    mesh = row_mesh(eight_devices)
    ref = solve_rowsharded(fns, x0, dims, opts, tols, mesh=mesh)

    def res(x, d):
        z = d["W"] @ x
        return d["Y"] - (z + 0.1 * jnp.tanh(z))

    fns_d = Functions(res=res, jac_res=jax.jacfwd(res),
                      cons=lambda x, d: _ineq(x),
                      jac_cons=lambda x, d: jax.jacfwd(_ineq)(x))
    data = {"W": jnp.asarray(_W), "Y": jnp.asarray(_Y)}
    carry = solve_rowsharded(fns_d, x0, dims, opts, tols, mesh=mesh,
                             data=data)
    assert len(carry.rx.sharding.device_set) == len(eight_devices)
    np.testing.assert_allclose(np.asarray(carry.x), np.asarray(ref.x),
                               atol=1e-12)
    assert int(carry.exit_code) == int(ref.exit_code)
