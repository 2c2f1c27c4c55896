"""Checkpoint/resume: saving mid-solve state and resuming must reach
the same answer as an uninterrupted solve."""

import jax
import jax.numpy as jnp
import numpy as np

import enlsip_tpu as et
from enlsip_tpu.core.driver import Functions, init_carry, iterate_body
from enlsip_tpu.core.types import Dims, Options, Tols
from enlsip_tpu.models.model import build_constraint_functions
from enlsip_tpu.utils import load_carry, save_carry

from problems import HS65


def _setup():
    model = et.CnlsModel(**HS65)
    cons, jac_cons = build_constraint_functions(model)
    fns = Functions(res=HS65["residuals"],
                    jac_res=HS65["jacobian_residuals"],
                    cons=cons, jac_cons=jac_cons)
    dims = Dims(n=3, m=3, q=0, l=7)
    eps = float(jnp.finfo(jnp.float64).eps)
    rel = float(np.sqrt(eps))
    tols = Tols(*(jnp.float64(v) for v in (1e-10, rel, rel, rel, rel)))
    return fns, dims, Options(), tols


def test_checkpoint_roundtrip(tmp_path):
    from functools import partial
    fns, dims, opts, tols = _setup()
    step = jax.jit(partial(iterate_body, fns=fns, dims=dims, opts=opts,
                           tols=tols))
    x0 = jnp.asarray(HS65["starting_point"], jnp.float64)
    carry = init_carry(fns, x0, dims, opts, jnp.float64)
    # run 3 iterations, checkpoint, run to completion
    for _ in range(3):
        carry = step(carry)
    path = str(tmp_path / "state.npz")
    save_carry(path, carry)

    resumed = load_carry(path, like=carry)
    for a, b in zip(jax.tree.leaves(carry), jax.tree.leaves(resumed)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def finish(c):
        while int(c.exit_code) == 0:
            c = step(c)
        return c

    c1 = finish(carry)
    c2 = finish(resumed)
    np.testing.assert_array_equal(np.asarray(c1.x), np.asarray(c2.x))
    assert int(c1.exit_code) == int(c2.exit_code)


def test_checkpoint_sharded_fused_resume(tmp_path):
    """Design-point layout (dryrun layout 5: fused hetero scenario
    batch, batch axis sharded over the mesh): checkpoint mid-solve,
    reload, re-pin the sharding, continue — BIT-IDENTICAL to the
    uninterrupted run.  CI runs it at B=128 over the
    8-device virtual mesh; __graft_entry__.dryrun_multichip runs the
    same save/load/continue at the full 1M-lane scale."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from enlsip_tpu.parallel.batch import (_run_batch_chunk_jit, finalize,
                                           init_batch)
    from enlsip_tpu.parallel.hetero import fuse_families
    from enlsip_tpu.parallel.sharding import batch_mesh
    from enlsip_tpu.parallel.suite import hs_scenario_batch

    mesh = batch_mesh()
    assert mesh.devices.size == 8  # conftest's virtual CPU mesh
    fams = hs_scenario_batch(["hs14", "hs65"], per_family=64, seed=0)
    fused = fuse_families(fams)
    dtype = jnp.float64
    eps = float(jnp.finfo(dtype).eps)
    rel = float(np.sqrt(eps))
    tols = Tols(*(jnp.asarray(v, dtype)
                  for v in (1e-10, rel, rel, rel, rel)))
    opts = Options(max_iter=40)
    sh = NamedSharding(mesh, P("batch"))

    def put(t):
        return jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), sh), t)

    x0 = jax.device_put(jnp.asarray(fused.x0, dtype), sh)
    data, rdims = put(fused.data), put(fused.rdims)
    carry = init_batch(fused.fns, x0, fused.dims, opts, dtype, data, rdims)
    mid = _run_batch_chunk_jit(carry, tols, jnp.int32(3), data, rdims,
                               fused.fns, fused.dims, opts)

    path = str(tmp_path / "sharded.npz")
    save_carry(path, mid)
    resumed = put(load_carry(path, like=mid))  # re-pin the batch sharding
    for a, b in zip(jax.tree.leaves(mid), jax.tree.leaves(resumed)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    fin1 = finalize(_run_batch_chunk_jit(mid, tols, jnp.int32(100), data,
                                         rdims, fused.fns, fused.dims, opts))
    fin2 = finalize(_run_batch_chunk_jit(resumed, tols, jnp.int32(100), data,
                                         rdims, fused.fns, fused.dims, opts))
    np.testing.assert_array_equal(np.asarray(fin1.exit_code),
                                  np.asarray(fin2.exit_code))
    np.testing.assert_array_equal(np.asarray(fin1.x), np.asarray(fin2.x))
    np.testing.assert_array_equal(np.asarray(fin1.n_iter),
                                  np.asarray(fin2.n_iter))
    assert np.all(np.asarray(fin1.exit_code) != 0)  # actually finished


def test_load_without_like(tmp_path):
    fns, dims, opts, tols = _setup()
    x0 = jnp.asarray(HS65["starting_point"], jnp.float64)
    carry = init_carry(fns, x0, dims, opts, jnp.float64)
    path = str(tmp_path / "state.npz")
    save_carry(path, carry)
    resumed = load_carry(path)
    np.testing.assert_array_equal(np.asarray(resumed.x), np.asarray(carry.x))


def test_load_v1_format_migrates(tmp_path):
    """A pre-version file (v1: trailing time_exceeded leaf, no
    __format_version__ entry) loads by dropping the obsolete leaf."""
    fns, dims, opts, tols = _setup()
    x0 = jnp.asarray(HS65["starting_point"], jnp.float64)
    carry = init_carry(fns, x0, dims, opts, jnp.float64)
    leaves = [np.asarray(l) for l in jax.tree.leaves(carry)]
    leaves.append(np.asarray(False))  # v1 time_exceeded
    path = str(tmp_path / "v1.npz")
    np.savez(path, **{f"leaf_{i}": l for i, l in enumerate(leaves)})
    resumed = load_carry(path, like=carry)
    np.testing.assert_array_equal(np.asarray(resumed.x), np.asarray(carry.x))
    assert len(jax.tree.leaves(resumed)) == len(jax.tree.leaves(carry))


def test_load_wrong_leaf_count_errors(tmp_path):
    fns, dims, opts, tols = _setup()
    x0 = jnp.asarray(HS65["starting_point"], jnp.float64)
    carry = init_carry(fns, x0, dims, opts, jnp.float64)
    leaves = [np.asarray(l) for l in jax.tree.leaves(carry)][:-3]
    path = str(tmp_path / "bad.npz")
    np.savez(path, **{f"leaf_{i}": l for i, l in enumerate(leaves)})
    import pytest
    with pytest.raises(ValueError, match="incompatible"):
        load_carry(path, like=carry)
