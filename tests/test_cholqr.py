"""Shifted-CholeskyQR tall-panel factorization (ops/tsqr.CholQRF) —
the GEMM-speed default (Options.tall_qr="cholqr") for giant-m J2 panels.

Must reproduce the direct CPQR's pivoting, R magnitudes, rank logic,
and every consumer-level quantity (triangular solves on d, prefix
norms, norm preservation); the end-to-end tall solve must match the
Householder-stage path (tall_qr="qr").
"""

import jax
import jax.numpy as jnp
import numpy as np

from enlsip_tpu.core.driver import Functions, init_carry, run_chunk
from enlsip_tpu.core.types import Dims, Options, Tols
from enlsip_tpu.ops.blocked_qr import cpqr_blocked, qt_apply
from enlsip_tpu.ops.qr import pseudo_rank
from enlsip_tpu.ops.tsqr import cholqr_cpqr, qt_apply_cholqr


def test_cholqr_matches_direct_cpqr():
    rng = np.random.default_rng(5)
    m, n = 8192, 12
    M = jnp.asarray(rng.normal(size=(m, n)))
    M = M.at[:, 10:].set(0.0)  # masked dead columns like a J2 buffer

    direct = jax.jit(lambda M: cpqr_blocked(M))(M)
    chol = jax.jit(lambda M: cholqr_cpqr(M, nsteps=n))(M)

    np.testing.assert_array_equal(np.asarray(chol.perm),
                                  np.asarray(direct.perm))
    np.testing.assert_allclose(np.abs(np.asarray(chol.diag)),
                               np.abs(np.asarray(direct.diag)), rtol=1e-9)
    Rd, Rc = np.asarray(direct.R)[:n], np.asarray(chol.R)[:n]
    sign = np.sign(np.diagonal(Rd)) * np.sign(np.diagonal(Rc))
    sign = np.where(sign == 0, 1.0, sign)
    np.testing.assert_allclose(sign[:, None] * Rc, Rd, atol=1e-8)

    # Consumer-level d: triangular solves and cumulative profiles agree
    # (raw coefficients may differ by the basis sign convention, which
    # no consumer reads individually).
    v = jnp.asarray(rng.normal(size=m))
    dc = np.asarray(jax.jit(qt_apply_cholqr)(chol, v))
    dd = np.asarray(jax.jit(qt_apply)(direct, v))
    np.testing.assert_allclose(np.sum(dc * dc), float(jnp.dot(v, v)),
                               rtol=1e-12)
    for r in (4, 8, 10):
        xc = np.linalg.solve(Rc[:r, :r], dc[:r])
        xd = np.linalg.solve(Rd[:r, :r], dd[:r])
        np.testing.assert_allclose(xc, xd, atol=1e-10)
    np.testing.assert_allclose(np.cumsum(dc[:10] ** 2),
                               np.cumsum(dd[:10] ** 2), rtol=1e-10)


def test_cholqr_rank_deficiency_detected():
    rng = np.random.default_rng(6)
    m = 4096
    M = np.asarray(rng.normal(size=(m, 6)))
    M[:, 5] = 2.0 * M[:, 0] + M[:, 1]          # dependent live column
    f = cholqr_cpqr(jnp.asarray(M), nsteps=6)
    assert int(pseudo_rank(f.diag, jnp.int32(6), jnp.asarray(1e-8))) == 5
    # all-dead buffer: finite zeros, rank 0
    f0 = cholqr_cpqr(jnp.zeros((4096, 6)), nsteps=6)
    assert np.isfinite(np.asarray(f0.R)).all()
    assert int(pseudo_rank(f0.diag, jnp.int32(6), jnp.asarray(1e-8))) == 0


def _tall_problem(m=40_000, n=24, with_trial=False):
    rng = np.random.default_rng(9)
    W = jnp.asarray(rng.normal(size=(m, n)).astype(np.float64) / np.sqrt(n))
    xt = rng.normal(size=n)
    Y = jnp.asarray(np.asarray(W) @ xt + 0.01 * rng.normal(size=m))
    blo = jnp.asarray(xt[:3] + 0.1)

    def res(x):
        z = W @ x
        return Y - (z + 0.05 * jnp.tanh(z))

    def jac(x):
        z = W @ x
        return -(1.0 + 0.05 * (1.0 - jnp.tanh(z) ** 2))[:, None] * W

    def cons(x):
        return jnp.concatenate([x[:3] - blo, x[3:6] + 10.0])

    def res_trial(x, p):
        zx, zp = W @ x, W @ p

        def at(a):
            u = zx + a.astype(zx.dtype) * zp
            return Y - (u + 0.05 * jnp.tanh(u))

        return at

    fns = Functions(res=res, jac_res=jac, cons=cons,
                    jac_cons=jax.jacfwd(cons),
                    res_trial=res_trial if with_trial else None)
    return fns, Dims(n=n, m=m, q=0, l=6)


def test_tall_solve_cholqr_matches_householder_path():
    """End-to-end giant-m-shaped solve: tall_qr='cholqr' and
    tall_qr='qr' must agree on the trajectory shape (iterations, exit,
    active set) and solution to factorization-noise tolerance."""
    fns, dims = _tall_problem()
    rel = float(np.sqrt(np.finfo(np.float64).eps))
    tols = Tols(*(jnp.float64(v) for v in (1e-10, rel, rel, rel, rel)))
    x0 = jnp.zeros(dims.n, jnp.float64)
    outs = {}
    for meth in ("cholqr", "qr"):
        opts = Options(second_derivatives=False, max_iter=30, tall_qr=meth)

        @jax.jit
        def run(x0, tols, opts=opts):
            c = init_carry(fns, x0, dims, opts, jnp.float64)
            c = run_chunk(c, fns, dims, opts, tols, opts.max_iter + 1)
            return c.x, c.nb_iter, c.exit_code, jnp.sum(c.active_mask)

        outs[meth] = jax.tree.map(np.asarray, run(x0, tols))
    xc, ic, ec, tc = outs["cholqr"]
    xq, iq, eq, tq = outs["qr"]
    assert int(ec) > 0 and int(eq) > 0, (ec, eq)
    assert int(ic) == int(iq), (ic, iq)
    assert int(tc) == int(tq), (tc, tq)
    np.testing.assert_allclose(xc, xq, atol=1e-8)


def test_res_trial_directional_hook_matches_blackbox():
    """Functions.res_trial (the directional line-search evaluation for
    structured residuals, here r = phi(W@x)): same trajectory shape and
    solution as the black-box default, same residual-counter contract
    (one bump per psi trial)."""
    rel = float(np.sqrt(np.finfo(np.float64).eps))
    tols = Tols(*(jnp.float64(v) for v in (1e-10, rel, rel, rel, rel)))
    opts = Options(second_derivatives=False, max_iter=30)
    outs = {}
    for with_trial in (False, True):
        fns, dims = _tall_problem(with_trial=with_trial)
        x0 = jnp.zeros(dims.n, jnp.float64)

        @jax.jit
        def run(x0, tols, fns=fns, dims=dims):
            c = init_carry(fns, x0, dims, opts, jnp.float64)
            c = run_chunk(c, fns, dims, opts, tols, opts.max_iter + 1)
            return c.x, c.nb_iter, c.exit_code, c.counters.nb_res

        outs[with_trial] = jax.tree.map(np.asarray, run(x0, tols))
    xb, ib, eb, rb = outs[False]
    xt, it, et, rt = outs[True]
    assert int(eb) > 0 and int(et) > 0, (eb, et)
    assert int(ib) == int(it), (ib, it)
    # Same counting CONTRACT (one bump per psi trial); the directional
    # form reassociates W@(x+a*p) as W@x + a*(W@p), whose last-bit
    # difference can flip a knife-edge trial, so counts may differ by a
    # couple of trials — not by a systematic factor.
    assert abs(int(rb) - int(rt)) <= 4, (rb, rt)
    np.testing.assert_allclose(xt, xb, atol=1e-8)


def test_cholqr2_refinement_improves_orthogonality_f64():
    """The f64 CholeskyQR2 refinement pass (round-3 advisor guard):
    implicit Q = M R1^{-1} R2^{-1} must be substantially more
    orthogonal than the single-pass M R1^{-1} in the mid-conditioning
    range, and never worse; the energy contract of qt_apply_cholqr
    must hold regardless of conditioning."""
    rng = np.random.default_rng(0)
    m, n = 512, 8
    U, _ = np.linalg.qr(rng.normal(size=(m, n)))
    V, _ = np.linalg.qr(rng.normal(size=(n, n)))
    v = jnp.asarray(rng.normal(size=m))
    for cond, max_ratio in ((1e4, 1.1), (1e6, 0.1), (1e8, 0.5)):
        s = np.logspace(0, -np.log10(cond), n)
        M = jnp.asarray((U * s) @ V.T)
        f = cholqr_cpqr(M, nsteps=n)
        assert f.R2 is not None  # refinement ran (f64)
        R1 = np.asarray(f.R1)
        R2 = np.asarray(f.R2)
        Q1 = np.linalg.solve(R1.T, np.asarray(M).T).T
        Q = np.linalg.solve(R2.T, Q1.T).T
        orth1 = np.linalg.norm(Q1.T @ Q1 - np.eye(n))
        orth = np.linalg.norm(Q.T @ Q - np.eye(n))
        assert orth <= max_ratio * orth1, (cond, orth, orth1)
        out = qt_apply_cholqr(f, v)
        assert abs(float(jnp.sum(out ** 2) - jnp.sum(v ** 2))) < 1e-10


def test_cholqr_f32_stays_single_pass():
    """At f32 the refinement is skipped (measured: marginal gains below
    cond ~1e3, destabilizing beyond ~1e4 — see cholqr_cpqr docstring)."""
    M = jnp.asarray(np.random.default_rng(1).normal(size=(256, 6)),
                    jnp.float32)
    f = cholqr_cpqr(M, nsteps=6)
    assert f.R2 is None
