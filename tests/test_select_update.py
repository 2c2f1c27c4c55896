"""Select-based update helpers (ops/select_update.py).

These exist to work around a backend miscompile of batched
``indices_are_sorted=True`` scatters (silently dropped updates for
batch rows >= 1024 — see the module docstring).  The tests here pin
the helpers' semantics to the ``.at`` forms at exactly the batch
scale where the scatter path went wrong, and assert per-lane batch
composition independence end-to-end through the solver.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from enlsip_tpu.ops.select_update import add1, set1, set_col, set_row


@pytest.mark.parametrize("B", [8, 4096])
def test_helpers_match_at_semantics(B):
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(B, 7)), jnp.float32)
    A = jnp.asarray(rng.normal(size=(B, 6, 5)), jnp.float32)
    i = jnp.asarray(rng.integers(0, 7, size=B), jnp.int32)
    k = jnp.asarray(rng.integers(0, 5, size=B), jnp.int32)
    r = jnp.asarray(rng.integers(0, 6, size=B), jnp.int32)
    col = jnp.asarray(rng.normal(size=(B, 6)), jnp.float32)
    row = jnp.asarray(rng.normal(size=(B, 5)), jnp.float32)

    out = jax.jit(jax.vmap(lambda v, i: set1(v, i, 3.5)))(v, i)
    tru = np.asarray(v).copy()
    tru[np.arange(B), np.asarray(i)] = 3.5
    np.testing.assert_array_equal(np.asarray(out), tru)

    out = jax.jit(jax.vmap(lambda v, i: add1(v, i, 2.0)))(v, i)
    tru = np.asarray(v).copy()
    tru[np.arange(B), np.asarray(i)] += 2.0
    np.testing.assert_allclose(np.asarray(out), tru)

    out = jax.jit(jax.vmap(set_col))(A, k, col)
    tru = np.asarray(A).copy()
    tru[np.arange(B), :, np.asarray(k)] = np.asarray(col)
    np.testing.assert_array_equal(np.asarray(out), tru)

    out = jax.jit(jax.vmap(set_row))(A, r, row)
    tru = np.asarray(A).copy()
    tru[np.arange(B), np.asarray(r), :] = np.asarray(row)
    np.testing.assert_array_equal(np.asarray(out), tru)

    # bool operand (the working-set mask case)
    m = jnp.ones((B, 7), bool)
    out = jax.jit(jax.vmap(lambda m, g: set1(m, g, False)))(m, i)
    tru = np.ones((B, 7), bool)
    tru[np.arange(B), np.asarray(i)] = False
    np.testing.assert_array_equal(np.asarray(out), tru)


def test_batch_composition_independence():
    """A lane's solve result must be bit-identical regardless of batch
    size, its position, and the other lanes' content (the invariant the
    scatter miscompile broke for B >= 1024)."""
    from enlsip_tpu.core.driver import Functions
    from enlsip_tpu.core.types import Dims, Options, Tols
    from enlsip_tpu.models.model import _model_functions
    from enlsip_tpu.parallel import solve_batched
    import enlsip_tpu as et
    from problems import HS65

    dtype = jnp.float64
    model = et.CnlsModel(**HS65)
    res_fn, jac_res, cons, jac_cons = _model_functions(model, dtype)
    fns = Functions(res=res_fn, jac_res=jac_res, cons=cons,
                    jac_cons=jac_cons)
    dims = Dims(n=3, m=3, q=0, l=7)
    eps = float(jnp.finfo(dtype).eps)
    rel = float(np.sqrt(eps))
    tols = Tols(*(jnp.asarray(v, dtype) for v in (1e-10, rel, rel, rel,
                                                  rel)))
    rng = np.random.default_rng(0)
    x0 = np.asarray(HS65["starting_point"])
    starts = x0[None, :] + 0.3 * rng.normal(size=(1536, 3))
    sub = starts[:64]

    small = solve_batched(fns, sub, dims, Options(), tols, dtype=dtype)
    # same 64 lanes at the TAIL of a 1536-lane batch (past the 1024
    # boundary where the miscompiled scatter dropped updates)
    big = solve_batched(fns, np.concatenate([starts[64:], sub]), dims,
                        Options(), tols, dtype=dtype)
    off = 1536 - 64
    np.testing.assert_array_equal(np.asarray(small.f),
                                  np.asarray(big.f)[off:])
    np.testing.assert_array_equal(np.asarray(small.exit_code),
                                  np.asarray(big.exit_code)[off:])
    np.testing.assert_array_equal(np.asarray(small.x),
                                  np.asarray(big.x)[off:])
