"""Edge cases the reference's own suite lacks (SURVEY.md §4 /
review_report recommendations): mixed Jacobian provision,
rank-deficient active Jacobians, working-set saturation (l > n),
scaling mode, max-norm penalty weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import enlsip_tpu as et

from problems import HS65, HS65_FSTAR


def test_mixed_jacobian_provision():
    """Residual Jacobian provided, constraint Jacobians from AD."""
    kw = dict(HS65)
    kw.pop("jacobian_ineqcons")
    model = et.CnlsModel(**kw)
    et.solve(model)
    assert et.sum_sq_residuals(model) == pytest.approx(HS65_FSTAR, abs=1e-7)

    kw2 = dict(HS65)
    kw2.pop("jacobian_residuals")
    model2 = et.CnlsModel(**kw2)
    et.solve(model2)
    assert et.sum_sq_residuals(model2) == pytest.approx(HS65_FSTAR, abs=1e-7)


def test_rank_deficient_active_jacobian():
    """Two duplicated equality constraints -> active Jacobian has
    rank 1 at every point; the stabilized (code -1) path must still
    reach the optimum of min (x1-2)^2 + (x2-1)^2 s.t. x1 + x2 = 1."""
    def res(x):
        return jnp.array([x[0] - 2.0, x[1] - 1.0])

    def eq(x):
        return jnp.array([x[0] + x[1] - 1.0, 2.0 * (x[0] + x[1] - 1.0)])

    model = et.CnlsModel(residuals=res, nb_parameters=2, nb_residuals=2,
                         eq_constraints=eq, nb_eqcons=2,
                         starting_point=np.array([0.0, 0.0]))
    et.solve(model)
    assert et.status(model) == "found_first_order_stationary_point"
    np.testing.assert_allclose(et.solution(model), [1.0, 0.0], atol=1e-6)


def _many_planes_problem(x0):
    def res(x):
        return x - jnp.array([2.0, 2.0, 2.0])

    def ineq(x):
        # 8 planes; more constraints than n = 3
        return jnp.array([x[0], x[1], x[2],
                          x[0] + x[1], x[1] + x[2], x[0] + x[2],
                          x[0] + x[1] + x[2],
                          1.0 + 0.0 * x[0]])

    return et.CnlsModel(residuals=res, nb_parameters=3, nb_residuals=3,
                        ineq_constraints=ineq, nb_ineqcons=8,
                        starting_point=np.asarray(x0, dtype=float))


def test_working_set_oversaturated_start():
    """From x0 = (-1,-1,-1) INIALC activates 7 > n constraints (the
    reference does NOT cap t at n at initialization).  At the origin
    vertex t > rankA, and the reference's deletion machinery cannot
    fire (the first-order deletion always rolls back — the feasible
    test at enlsip_functions.jl:728 is constant-false in the mounted
    source — and second-order deletion requires t == rankA), so the
    faithful outcome is a -10 infeasibility stall at the vertex."""
    model = _many_planes_problem([-1.0, -1.0, -1.0])
    et.solve(model)
    assert et.status(model) in ("failed", "found_first_order_stationary_point")
    assert np.isfinite(et.sum_sq_residuals(model))


def test_many_constraints_interior_start():
    """Same l > n problem from an interior point: no constraint ever
    activates (t = 0 path) and the solve reaches the unconstrained
    optimum."""
    model = _many_planes_problem([1.0, 1.0, 1.0])
    et.solve(model)
    assert et.status(model) == "found_first_order_stationary_point"
    np.testing.assert_allclose(et.solution(model), [2.0, 2.0, 2.0],
                               atol=1e-6)


def test_scaling_mode():
    """Internal row scaling of the active constraints (EVSCAL) must
    not change the HS65 answer."""
    model = et.CnlsModel(**HS65)
    et.solve(model, scaling=True)
    assert et.sum_sq_residuals(model) == pytest.approx(HS65_FSTAR, abs=1e-6)


def test_max_norm_weights():
    """weight_code=0 (MAXNRM penalty strategy) end-to-end.  The
    max-norm strategy keeps weights small (nu = max(mu, K4)) and on
    HS65 stalls near the optimum with a -6 merit-derivative exit — the
    reference's own default is the Euclidean strategy and ``solve!``
    does not even expose weight_code (solver.jl:62).  Assert the path
    runs and lands near the optimum."""
    model = et.CnlsModel(**HS65)
    et.solve(model, weight_code=0)
    assert et.status(model) in ("found_first_order_stationary_point",
                                "failed")
    assert et.sum_sq_residuals(model) == pytest.approx(HS65_FSTAR, abs=2e-2)


def test_f32_solve():
    """float32 (the accelerator dtype) with eps-scaled tolerances."""
    model = et.CnlsModel(**HS65)
    et.solve(model, dtype=jnp.float32)
    assert et.status(model) == "found_first_order_stationary_point"
    assert et.sum_sq_residuals(model) == pytest.approx(HS65_FSTAR, abs=1e-5)


def test_f32_corner_robustness():
    """Regression: from this start the f32 solve reaches the bound
    corner (-4.5, 4.5, 5) exactly; rounding used to leave a
    machine-epsilon-positive inactive bound that capped the steplength
    at ~1e-7 and stalled the lane (f64 escapes).  The UPBND threshold
    + f64 decision accumulation must recover it."""
    kw = dict(HS65)
    kw["starting_point"] = np.array([-5.22670127, 5.15938172, 0.22152288])
    model = et.CnlsModel(**kw)
    et.solve(model, dtype=jnp.float32)
    assert et.status(model) == "found_first_order_stationary_point"
    assert et.sum_sq_residuals(model) == pytest.approx(HS65_FSTAR, abs=1e-4)
