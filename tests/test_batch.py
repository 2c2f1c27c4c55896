"""Batched (vmap) and sharded (mesh) solve tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import enlsip_tpu as et
from enlsip_tpu.core.driver import Functions
from enlsip_tpu.core.types import Dims, Options, Tols
from enlsip_tpu.models.model import build_constraint_functions
from enlsip_tpu.parallel import (batch_mesh, solve_batched,
                                 solve_batched_sharded)

from problems import HS65, HS65_FSTAR


def _hs65_setup():
    model = et.CnlsModel(**HS65)
    cons, jac_cons = build_constraint_functions(model)
    fns = Functions(res=HS65["residuals"],
                    jac_res=HS65["jacobian_residuals"],
                    cons=cons, jac_cons=jac_cons)
    dims = Dims(n=3, m=3, q=0, l=7)
    opts = Options()
    eps = float(jnp.finfo(jnp.float64).eps)
    rel = float(np.sqrt(eps))
    tols = Tols(eps_abs=jnp.float64(1e-10), eps_rel=jnp.float64(rel),
                eps_x=jnp.float64(rel), eps_c=jnp.float64(rel),
                eps_rank=jnp.float64(rel))
    return fns, dims, opts, tols


def _perturbed_starts(B, seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(HS65["starting_point"])
    return x0[None, :] + 0.3 * rng.normal(size=(B, 3))


def test_solve_batched_hs65():
    fns, dims, opts, tols = _hs65_setup()
    B = 8
    res = solve_batched(fns, _perturbed_starts(B), dims, opts, tols)
    assert res.x.shape == (B, 3)
    ok = np.asarray(res.exit_code) > 0
    assert ok.all(), np.asarray(res.exit_code)
    np.testing.assert_allclose(np.asarray(res.f), HS65_FSTAR, atol=1e-6)


def test_solve_batched_matches_single():
    """Each batched lane must match the unbatched solve from the same
    start (bitwise trajectory parity of the masked formulation)."""
    fns, dims, opts, tols = _hs65_setup()
    starts = _perturbed_starts(8, seed=1)  # B=8 shares the jit cache
    res = solve_batched(fns, starts, dims, opts, tols)
    for i in range(4):
        single = et.core_solve(fns, jnp.asarray(starts[i]), dims, opts, tols)
        np.testing.assert_allclose(np.asarray(res.x[i]),
                                   np.asarray(single.x), atol=1e-12)
        assert int(res.n_iter[i]) == single.n_iter


def test_solve_batched_sharded(eight_devices):
    fns, dims, opts, tols = _hs65_setup()
    mesh = batch_mesh(eight_devices)
    B = 16
    res = solve_batched_sharded(fns, _perturbed_starts(B, seed=2), dims,
                                opts, tols, mesh=mesh)
    assert res.x.shape == (B, 3)
    assert (np.asarray(res.exit_code) > 0).all()
    np.testing.assert_allclose(np.asarray(res.f), HS65_FSTAR, atol=1e-6)


def test_solve_batched_sharded_lanes_stay_on_their_device(eight_devices):
    """Each device solves its own lanes: the results are sharded over
    every device of the mesh and equal the unsharded solve lane by lane."""
    fns, dims, opts, tols = _hs65_setup()
    mesh = batch_mesh(eight_devices)
    starts = _perturbed_starts(16, seed=5)
    res = solve_batched_sharded(fns, starts, dims, opts, tols, mesh=mesh)
    assert res.x.sharding.device_set == set(eight_devices)
    assert {s.data.shape[0] for s in res.x.addressable_shards} == {2}
    ref = solve_batched(fns, starts, dims, opts, tols)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-12)
    np.testing.assert_array_equal(np.asarray(res.exit_code),
                                  np.asarray(ref.exit_code))


def test_solve_batched_sharded_pads_uneven(eight_devices):
    fns, dims, opts, tols = _hs65_setup()
    mesh = batch_mesh(eight_devices)
    res = solve_batched_sharded(fns, _perturbed_starts(5, seed=3), dims,
                                opts, tols, mesh=mesh)
    assert res.x.shape == (5, 3)
    assert (np.asarray(res.exit_code) > 0).all()


def test_solve_batched_time_limit_expired():
    """time_limit <= 0: every unconverged lane exits -11
    (:time_limit_exceeded), mirroring the reference's chained_rosenbrock
    time-limit test (test/problems/chained_rosenbrock.jl:69-72)."""
    fns, dims, opts, tols = _hs65_setup()
    res = solve_batched(fns, _perturbed_starts(8), dims, opts, tols,
                        time_limit=-1.0)
    assert (np.asarray(res.exit_code) == -11).all(), np.asarray(res.exit_code)


def test_solve_batched_time_limit_generous_matches_unlimited():
    """A generous custom limit must produce the same per-lane results as
    the unlimited single-dispatch path (the chunked loop is a pure
    scheduling change)."""
    fns, dims, opts, tols = _hs65_setup()
    starts = _perturbed_starts(8, seed=2)
    ref = solve_batched(fns, starts, dims, opts, tols)
    lim = solve_batched(fns, starts, dims, opts, tols, time_limit=500.0)
    np.testing.assert_array_equal(np.asarray(ref.exit_code),
                                  np.asarray(lim.exit_code))
    np.testing.assert_allclose(np.asarray(ref.x), np.asarray(lim.x),
                               atol=0.0)
    np.testing.assert_array_equal(np.asarray(ref.n_iter),
                                  np.asarray(lim.n_iter))
