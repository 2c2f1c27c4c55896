"""f64-escalation mode: after a batched f32 solve,
re-solve a lane subset at f64 in one follow-up launch and merge.

Escalated lanes must reproduce a pure-f64 solve from the same starts
(the escalation restarts from x0, not the f32 iterate); untouched lanes
keep their f32 values; counters on escalated lanes sum both attempts.
"""

import jax
import jax.numpy as jnp
import numpy as np

from enlsip_tpu.core.driver import Functions
from enlsip_tpu.core.types import Dims, Options, Tols
from enlsip_tpu.parallel import solve_batched
from problems import HS65


def _hs65_setup():
    import enlsip_tpu as et
    from enlsip_tpu.models.model import _model_functions

    model = et.CnlsModel(**HS65)
    res, jac_res, cons, jac_cons = _model_functions(model, jnp.float32)
    fns = Functions(res=res, jac_res=jac_res, cons=cons, jac_cons=jac_cons)
    dims = Dims(n=3, m=3, q=0, l=7)
    rng = np.random.default_rng(7)
    x0 = np.asarray(HS65["starting_point"])
    starts = x0[None, :] + 0.3 * rng.normal(size=(6, 3))
    return fns, dims, starts


def test_escalate_mask_merges_f64_results():
    fns, dims, starts = _hs65_setup()
    opts = Options()
    mask = np.array([False, True, False, True, False, False])

    res32 = solve_batched(fns, starts, dims, opts,
                          Tols.for_dtype(jnp.float32), dtype=jnp.float32)
    res = solve_batched(fns, starts, dims, opts,
                        Tols.for_dtype(jnp.float32), dtype=jnp.float32,
                        escalate_mask=mask)
    with jax.enable_x64():
        ref64 = solve_batched(fns, starts[mask], dims, opts,
                              Tols.for_dtype(jnp.float64),
                              dtype=jnp.float64)

    assert res.escalated is not None
    np.testing.assert_array_equal(np.asarray(res.escalated), mask)
    assert res.x.dtype == jnp.float64

    # Escalated lanes == pure-f64 solve of the same starts.
    np.testing.assert_array_equal(np.asarray(res.x)[mask],
                                  np.asarray(ref64.x))
    np.testing.assert_array_equal(np.asarray(res.exit_code)[mask],
                                  np.asarray(ref64.exit_code))
    np.testing.assert_array_equal(np.asarray(res.f)[mask],
                                  np.asarray(ref64.f))
    # Untouched lanes keep the f32 values (cast only).
    np.testing.assert_array_equal(np.asarray(res.x)[~mask],
                                  np.asarray(res32.x)[~mask].astype(np.float64))
    np.testing.assert_array_equal(np.asarray(res.exit_code)[~mask],
                                  np.asarray(res32.exit_code)[~mask])
    # Counters on escalated lanes are the sum of both attempts.
    np.testing.assert_array_equal(
        np.asarray(res.counters.nb_res)[mask],
        np.asarray(res32.counters.nb_res)[mask]
        + np.asarray(ref64.counters.nb_res))


def test_escalate_f64_noop_when_all_converge():
    fns, dims, starts = _hs65_setup()
    res = solve_batched(fns, starts, dims, Options(),
                        Tols.for_dtype(jnp.float32), dtype=jnp.float32,
                        escalate_f64=True)
    assert np.all(np.asarray(res.exit_code) > 0)
    assert not np.any(np.asarray(res.escalated))
    # No-escalation fast path: values stay f32.
    assert res.x.dtype == jnp.float32


def test_escalate_f64_exit_code_rule():
    """Lanes that abort at f32 (here: forced -2 via a tiny iteration
    budget) are selected by the default exit_code <= 0 rule and re-run
    at f64 (same budget -> still -2, but the merge machinery and the
    two-attempt counter sum are exercised end-to-end)."""
    fns, dims, starts = _hs65_setup()
    opts = Options(max_iter=2)
    res32 = solve_batched(fns, starts, dims, opts,
                          Tols.for_dtype(jnp.float32), dtype=jnp.float32)
    assert np.all(np.asarray(res32.exit_code) == -2)
    res = solve_batched(fns, starts, dims, opts,
                        Tols.for_dtype(jnp.float32), dtype=jnp.float32,
                        escalate_f64=True)
    assert np.all(np.asarray(res.escalated))
    # Merged codes are the f64 re-solve's own codes (the f64 trajectory
    # may abort differently within the same tiny budget, e.g. -6).
    with jax.enable_x64():
        ref64 = solve_batched(fns, starts, dims, opts,
                              Tols.for_dtype(jnp.float64),
                              dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(res.exit_code),
                                  np.asarray(ref64.exit_code))
    assert np.all(np.asarray(res.counters.nb_res)
                  > np.asarray(res32.counters.nb_res))
