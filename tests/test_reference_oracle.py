"""Reference-oracle golden trajectories.

``oracle_enlsip.py`` is a plain-numpy transliteration of the reference
loop (enlsip_functions.jl:2638-2880 + every routine it calls).  These
tests run the JAX solver and the oracle on the same problems at f64 and
assert the per-iteration (method code, working-set size, rankA, alpha)
sequences and final (exit code, f) agree — pinning the implementation
to *reference-derived* trajectories instead of to itself.

Verified agreement (recorded 2026-08-17):
  * HS65  — 14 iterations, exit 10300, f = 0.9535288568; alphas match
    to 1e-12 except the final converged-flat iteration.
  * CW8   — 57 iterations incl. Newton steps (code 2) at 54-56, exit
    10000, f = 43.106918096; AD vs the reference's FD Hessians makes
    no trajectory difference here.
  * CR10  — 7 undamped GN iterations, exit 10000, f = 6.2324586324.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import enlsip_tpu as et
import oracle_enlsip as oe
from enlsip_tpu.core.driver import Functions, init_carry, iterate_body
from enlsip_tpu.core.types import Dims, Options, Tols
from enlsip_tpu.models.model import _model_functions
from problems import HS65, chained_rosenbrock, chained_wood

EPS = float(jnp.finfo(jnp.float64).eps)
REL = float(np.sqrt(EPS))


def _jax_trace(model, dims, max_steps, opts=Options()):
    r_, jr_, c_, jc_ = _model_functions(model, jnp.float64)
    fns = Functions(res=r_, jac_res=jr_, cons=c_, jac_cons=jc_)
    tols = Tols(*(jnp.float64(v) for v in (1e-10, REL, REL, REL, REL)))
    step = jax.jit(partial(iterate_body, fns=fns, dims=dims,
                           opts=opts, tols=tols))
    carry = init_carry(fns, jnp.asarray(model.starting_point), dims,
                       opts, jnp.float64)
    rows = []
    for _ in range(max_steps):
        if int(carry.exit_code) != 0:
            break
        carry = step(carry)
        rows.append((int(carry.prev.code), int(carry.prev.t),
                     int(carry.prev.rankA), float(carry.prev.alpha)))
    return rows, int(carry.exit_code), float(jnp.dot(carry.rx, carry.rx))


def _oracle_trace(model, dims, scaling=False):
    r_, jr_, c_, jc_ = _model_functions(model, jnp.float64)
    fns = oe.Fns(lambda x: np.asarray(r_(jnp.asarray(x))),
                 lambda x: np.asarray(jr_(jnp.asarray(x))),
                 lambda x: np.asarray(c_(jnp.asarray(x))),
                 lambda x: np.asarray(jc_(jnp.asarray(x))))
    res = oe.enlsip(np.asarray(model.starting_point, float), fns,
                    dims.n, dims.m, dims.q, dims.l, eps_abs=1e-10,
                    eps_rel=REL, eps_x=REL, eps_c=REL, eps_rank=REL,
                    scaling=scaling)
    rows = [(tr.code, tr.t, tr.rankA, float(tr.alpha))
            for tr in res.trace]
    return rows, res.exit_code, res.f


def _assert_parity(jax_out, oracle_out, name):
    jrows, jexit, jf = jax_out
    orows, oexit, of = oracle_out
    assert jexit == oexit, (name, jexit, oexit)
    assert len(jrows) == len(orows), (name, len(jrows), len(orows))
    for i, (a, b) in enumerate(zip(jrows, orows)):
        assert a[:3] == b[:3], (name, i, a, b)
        # alpha: exact-trajectory match except the final converged-flat
        # iteration, where the merit is numerically flat and FP noise
        # in two different QR implementations dominates.
        if i < len(jrows) - 1:
            assert abs(a[3] - b[3]) <= 1e-6 * max(1.0, abs(b[3])), \
                (name, i, a[3], b[3])
    np.testing.assert_allclose(jf, of, rtol=1e-8, err_msg=name)


def test_hs65_matches_reference_oracle():
    model = et.CnlsModel(**HS65)
    dims = Dims(n=3, m=3, q=0, l=7)
    _assert_parity(_jax_trace(model, dims, 40),
                   _oracle_trace(model, dims), "HS65")


def test_chained_rosenbrock10_matches_reference_oracle():
    kw = chained_rosenbrock(10)
    model = et.CnlsModel(**kw)
    dims = Dims(n=10, m=kw["nb_residuals"], q=kw["nb_eqcons"],
                l=kw["nb_eqcons"])
    _assert_parity(_jax_trace(model, dims, 40),
                   _oracle_trace(model, dims), "CR10")


def test_chained_wood8_matches_reference_oracle():
    """Exercises the Newton path (code 2) against the oracle's
    reference-exact FD-Hessian Newton direction."""
    kw = chained_wood(8)
    model = et.CnlsModel(**kw)
    dims = Dims(n=8, m=kw["nb_residuals"], q=kw["nb_eqcons"],
                l=kw["nb_eqcons"])
    jax_out = _jax_trace(model, dims, 80)
    oracle_out = _oracle_trace(model, dims)
    _assert_parity(jax_out, oracle_out, "CW8")
    assert any(c == 2 for c, _, _, _ in jax_out[0])  # Newton engaged


_MEYER_T = np.arange(1, 17) * 5.0 + 45.0
_MEYER_Y = np.array([34780., 28610., 23650., 19630., 16370., 13720., 11540.,
                     9744., 8261., 7030., 6005., 5147., 4427., 3820., 3307.,
                     2872.])


def _meyer_res(x):
    """Meyer's stiff exponential fit (NIST MGH10): the classic
    slow-GN/ill-conditioned trajectory."""
    return x[0] * jnp.exp(x[1] / (jnp.asarray(_MEYER_T) + x[2])) \
        - jnp.asarray(_MEYER_Y)


def test_meyer_subspace_trajectory_matches_reference_oracle():
    """Exercises the SUBSPACE-MINIMIZATION path (method code -1,
    GNDCHK -> SUBSPC/DIMUPP -> SUBDIR with truncated dims) against the
    oracle: the trajectory visits code -1 three times, relabels back to
    GN, escalates to Newton, and exits through the abnormal -3 (Newton
    Cholesky failure) — every leg matching the reference oracle with
    identical alphas to ~1e-9 (verified codes:
    [1,1,1,1,1,-1,1,-1,-1,1,2,2,2,2,2])."""
    model = et.CnlsModel(
        residuals=_meyer_res, nb_parameters=3, nb_residuals=16,
        starting_point=np.array([0.02, 4000.0, 250.0]),
        ineq_constraints=lambda x: jnp.array([x[2] + 1000.0]),
        nb_ineqcons=1)
    dims = Dims(n=3, m=16, q=0, l=1)
    jax_out = _jax_trace(model, dims, 60)
    oracle_out = _oracle_trace(model, dims)
    jrows, jexit, _ = jax_out
    assert any(c == -1 for c, _, _, _ in jrows), jrows  # subspace engaged
    assert jexit == -3
    # full structural parity; alphas compared by the shared harness
    assert jexit == oracle_out[1]
    assert [r[:3] for r in jrows] == [r[:3] for r in oracle_out[0]]
    for a, b in zip(jrows, oracle_out[0]):
        assert abs(a[3] - b[3]) <= 1e-6 * max(1.0, abs(b[3])), (a, b)


def test_hs65_scaling_matches_reference_oracle():
    """scaling=True (EVSCAL row scaling of the active constraints,
    structures.jl:160-178) trajectory pinned against the oracle's
    scaling mode: codes/t/rankA identical, same exit and optimum."""
    model = et.CnlsModel(**HS65)
    dims = Dims(n=3, m=3, q=0, l=7)
    jrows, jexit, jf = _jax_trace(model, dims, 40, Options(scaling=True))
    orows, oexit, of = _oracle_trace(model, dims, scaling=True)
    assert jexit == oexit and jexit == 10300
    assert [r[:3] for r in jrows] == [r[:3] for r in orows]
    np.testing.assert_allclose(jf, of, rtol=1e-8)
    np.testing.assert_allclose(jf, 0.9535288567, rtol=1e-7)


def test_oracle_standalone_hs65_hits_published_optimum():
    """The oracle itself must reproduce the published HS65 solution
    (docs/src/tutorial.md:126-128) — guards the oracle against bugs."""
    model = et.CnlsModel(**HS65)
    dims = Dims(n=3, m=3, q=0, l=7)
    rows, exit_code, f = _oracle_trace(model, dims)
    assert exit_code > 0
    np.testing.assert_allclose(f, 0.9535288567, rtol=1e-7)
