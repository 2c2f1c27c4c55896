"""Regression tests for the dpsi0 noise floor (PARITY.md D10) and the
UPBND evaluation-noise candidacy threshold (PARITY.md D7).

The -6 exit (merit derivative not a descent direction) fires on
dpsi0 >= 0 in the reference (enlsip_functions.jl:2238-2250).  At f32 a
converged lane's dpsi0 is pure cancellation roundoff and can land at
+O(eps*scale); the solver only treats dpsi0 as true ascent when it
clears 10*eps(dtype)*dpsi_scale, where dpsi_scale sums the magnitudes
of dpsi0's own summands with the same fcx gate the summands carry
(a review finding: an inflated floor hid genuine ascent).

The UPBND threshold: a strictly-positive inactive cx caps the step at
the constraint boundary (reference :2149-2178).  Round 1 replaced the
strict 0 test with sqrt(eps) for f32 stall robustness; that window was
wide enough to let genuinely-feasible near-boundary constraints escape
the cap, so a near-optimum f32 start could fly deep infeasible on the
unconstrained GN step and fail -6 during recovery.  The threshold is
now the constraint's own evaluation-noise scale eps*(1+|grad c|*|x|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import enlsip_tpu as et
from enlsip_tpu.core.driver import Functions, solve as core_solve
from enlsip_tpu.core.types import Dims, Options, Tols
from enlsip_tpu.core.weights import penalty_weight_update
from enlsip_tpu.models.model import _model_functions
from problems import HS65, HS65_FSTAR

from test_reference_oracle import _assert_parity, _jax_trace, _oracle_trace


def _tols(dtype):
    eps = float(jnp.finfo(dtype).eps)
    rel = float(np.sqrt(eps))
    return Tols(eps_abs=jnp.asarray(1e-10, dtype),
                eps_rel=jnp.asarray(rel, dtype),
                eps_x=jnp.asarray(rel, dtype),
                eps_c=jnp.asarray(rel, dtype),
                eps_rank=jnp.asarray(rel, dtype))


def test_dpsi_scale_fcx_gating():
    """When nrm_cx == 0 (all active cx within dimA are zero) the
    reference's normalization zeroes every cx-carrying product; the
    noise scale must drop those terms too, even when active slots
    BEYOND dimA carry large cx (an inflated floor can classify
    genuine ascent as descent)."""
    dims = Dims(n=3, m=4, q=0, l=5)
    rng = np.random.default_rng(7)
    Jp = rng.normal(size=4)
    rx = rng.normal(size=4)
    cx = np.zeros(5)
    cx[2] = 5.0          # active slot 2 (beyond dimA=2) has LARGE cx
    active_global = np.asarray([0, 1, 2, 3, 4], np.int32)
    valid = np.array([True, True, True, False, False])
    active_Ap = np.where(valid, rng.normal(size=5), 0.0)
    w_old = np.full(5, 0.3)
    K = np.full((4, 5), 0.05)
    w, dpsi0, dpsi_scale, _ = penalty_weight_update(
        jnp.asarray(w_old), jnp.asarray(Jp), jnp.asarray(active_Ap),
        jnp.asarray(K), jnp.asarray(rx), jnp.asarray(cx),
        jnp.asarray(active_global), jnp.asarray(valid), jnp.int32(3),
        jnp.int32(2), 2, dims, 8)
    # fcx == 0: dpsi0 is exactly Jp.rx and the scale is exactly the
    # |Jp_i rx_i| summand magnitudes — no constraint contribution.
    np.testing.assert_allclose(float(dpsi0), float(np.dot(Jp, rx)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(dpsi_scale),
                               float(np.sum(np.abs(Jp * rx))), rtol=1e-12)


def test_dpsi_scale_uses_summand_magnitudes():
    """The Jp.rx part of the scale must be sum|Jp_i rx_i| (the
    pre-cancellation magnitude), not |dot(Jp, rx)| — at a stationary
    point the dot product itself cancels to ~0 and would produce a
    floor far below the actual roundoff in dpsi0."""
    dims = Dims(n=2, m=2, q=0, l=1)
    Jp = np.array([1.0, -1.0])
    rx = np.array([1.0, 1.0])          # dot = 0, sum|.| = 2
    cx = np.zeros(1)
    active_global = np.asarray([0], np.int32)
    valid = np.array([False])
    active_Ap = np.zeros(1)
    w_old = np.full(1, 0.1)
    K = np.full((4, 1), 0.05)
    _, dpsi0, dpsi_scale, _ = penalty_weight_update(
        jnp.asarray(w_old), jnp.asarray(Jp), jnp.asarray(active_Ap),
        jnp.asarray(K), jnp.asarray(rx), jnp.asarray(cx),
        jnp.asarray(active_global), jnp.asarray(valid), jnp.int32(0),
        jnp.int32(0), 2, dims, 8)
    assert abs(float(dpsi0)) < 1e-12
    np.testing.assert_allclose(float(dpsi_scale), 2.0, rtol=1e-12)


# Near-optimum starting points that failed -6 in f32 before the UPBND
# evaluation-noise threshold (found by scanning perturbed starts: the
# active constraint's cx rounds to +3e-5 at f32, the old sqrt(eps)
# candidacy window excluded it from the step cap, and the unconstrained
# GN step flew deep infeasible).
NEAR_OPT_STARTS = [
    [3.650460926003898, 3.6504611463281638, 4.620415098606704],
    [3.6504710148801114, 3.6504601537952532, 4.620404418624625],
    [3.650462803812105, 3.6504602004746007, 4.620417402536105],
]


@pytest.mark.parametrize("x0", NEAR_OPT_STARTS)
def test_f32_near_optimum_start_converges(x0):
    """f32 solves from starts within ~1e-5 of the HS65 optimum must
    exit with a positive status AT the published optimum (previously:
    exit -6 at an infeasible point with f < f*)."""
    kw = dict(HS65)
    kw["starting_point"] = x0
    model = et.CnlsModel(**kw)
    dims = Dims(n=3, m=3, q=0, l=7)
    dtype = jnp.float32
    r_, jr_, c_, jc_ = _model_functions(model, dtype)
    fns = Functions(res=r_, jac_res=jr_, cons=c_, jac_cons=jc_)
    res = core_solve(fns, jnp.asarray(x0, dtype), dims, Options(),
                     _tols(dtype), dtype=dtype)
    assert res.exit_code > 0, res.exit_code
    assert abs(res.f - HS65_FSTAR) < 1e-4, res.f


def test_f64_near_boundary_matches_reference_oracle():
    """D10 parity pin: an f64 trajectory that starts near-optimal (the
    regime where dpsi0 approaches the noise floor and the first step is
    capped at the active-constraint boundary) must still make the same
    DECISIONS as the reference oracle per-iteration (method code,
    working-set size, rankA) and reach the same exit and optimum — the
    D10 floor and D7 threshold change nothing at f64 on real
    trajectories.  Exact alpha parity is not asserted here: iteration
    0's boundary-capped alpha is ~1e-6 and FP-noise dominated, so the
    two QR implementations' alphas diverge at the % level downstream
    while the decision path stays identical."""
    kw = dict(HS65)
    kw["starting_point"] = NEAR_OPT_STARTS[0]
    model = et.CnlsModel(**kw)
    dims = Dims(n=3, m=3, q=0, l=7)
    jrows, jexit, jf = _jax_trace(model, dims, 40)
    orows, oexit, of = _oracle_trace(model, dims)
    assert jexit == oexit, (jexit, oexit)
    assert [r[:3] for r in jrows] == [r[:3] for r in orows]
    # Iteration 0 IS boundary-capped (the D7 window kept the candidacy).
    assert jrows[0][3] < 1e-4 and orows[0][3] < 1e-4
    np.testing.assert_allclose(jf, of, rtol=1e-8)
    np.testing.assert_allclose(jf, HS65_FSTAR, rtol=1e-7)
