"""Fused batched Pallas (Triton) CPQR vs the vmapped XLA loop.

The kernel (ops/pallas_batched_qr.py) factorizes a whole block of lanes
in one program; interpret mode runs it on the CPU.  It must reproduce
``jax.vmap(cpqr_blocked)``
bit-compatibly (same pivot order, same no-op semantics on masked
columns) so the batched solver can dispatch to it transparently through
the ``custom_vmap`` rule in ops/blocked_qr.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from enlsip_tpu.ops import blocked_qr as bq
from enlsip_tpu.ops import pallas_batched_qr as pbq
from enlsip_tpu.ops.blocked_qr import _cpqr_small, cpqr_blocked


def _assert_cpqrf_close(f1, f2, atol):
    np.testing.assert_array_equal(np.asarray(f1.perm), np.asarray(f2.perm))
    for name in ("R", "V", "tau", "T", "diag"):
        np.testing.assert_allclose(np.asarray(getattr(f1, name)),
                                   np.asarray(getattr(f2, name)),
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("rows,cols,live", [(3, 7, 2), (7, 3, 3),
                                            (16, 20, 9), (5, 5, 5)])
def test_batched_kernel_matches_vmapped_loop(rows, cols, live):
    """Masked trailing columns + per-lane nsteps: the fused kernel runs
    all kmax steps, the XLA loop only ``live`` — results must agree
    (dead steps are tau = 0 no-ops)."""
    rng = np.random.default_rng(0)
    B = 9
    M = rng.normal(size=(B, rows, cols))
    M[:, :, live:] = 0.0
    M = jnp.asarray(M, jnp.float32)
    ns = jnp.full((B,), live, jnp.int32)
    f1 = pbq.cpqr_blocked_batched(M, interpret=True)
    f2 = jax.vmap(lambda m, n: cpqr_blocked(m, nsteps=n))(M, ns)
    _assert_cpqrf_close(f1, f2, atol=5e-5)


def test_custom_vmap_dispatch(monkeypatch):
    """vmap of _cpqr_small routes through the fused kernel (interpret
    mode stands in for the GPU kernel on CPU) and matches the loop."""
    calls = []
    real = pbq.cpqr_blocked_batched

    def fake_batched(M):
        calls.append(M.shape)
        return real(M, interpret=True)

    monkeypatch.setattr(pbq, "cpqr_blocked_batched", fake_batched)
    rng = np.random.default_rng(1)
    M = jnp.asarray(rng.normal(size=(6, 8, 5)), jnp.float32)
    ns = jnp.full((6,), 5, jnp.int32)
    f1 = jax.vmap(_cpqr_small)(M, ns)
    assert calls == [(6, 8, 5)]
    f2 = jax.vmap(lambda m, n: bq._cpqr_xla(m, bq.NB, n))(M, ns)
    _assert_cpqrf_close(f1, f2, atol=5e-5)


def test_unbatched_small_path_unchanged():
    """Outside vmap, _cpqr_small is exactly the XLA loop."""
    rng = np.random.default_rng(2)
    M = jnp.asarray(rng.normal(size=(8, 5)), jnp.float32)
    f1 = _cpqr_small(M, jnp.int32(5))
    f2 = bq._cpqr_xla(M, bq.NB, jnp.int32(5))
    _assert_cpqrf_close(f1, f2, atol=0.0)


def test_gate_rejects_cpu_and_big_shapes(monkeypatch):
    assert not bq._use_batched_pallas(8, 8, jnp.float32)  # cpu backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert bq._use_batched_pallas(8, 8, jnp.float32)
    assert not bq._use_batched_pallas(8, 8, jnp.float64)
    assert bq._use_batched_pallas(16, 32, jnp.float32)       # widest
    assert not bq._use_batched_pallas(32, 32, jnp.float32)   # kmax > 16
    assert not bq._use_batched_pallas(1024, 2, jnp.float32)  # elems


@pytest.mark.parametrize("B", [513, 650, 1100])
def test_batched_cpqr_partial_block(B):
    """B % lane_block != 0: the trailing partial block must be processed
    (masked loads/stores; lanes past B are never written)."""
    rng = np.random.default_rng(B)
    rows, cols = 6, 5
    assert B % pbq.lane_block(rows, cols, B)
    M = jnp.asarray(rng.normal(size=(B, rows, cols)), jnp.float32)
    f1 = pbq.cpqr_blocked_batched(M, interpret=True)
    f2 = jax.vmap(lambda m: cpqr_blocked(m))(M)
    assert np.isfinite(np.asarray(f1.R)).all()
    # the tail lanes specifically
    _assert_cpqrf_close(
        jax.tree.map(lambda a: a[-64:], f1),
        jax.tree.map(lambda a: a[-64:], f2), atol=5e-5)
    _assert_cpqrf_close(f1, f2, atol=5e-5)


@pytest.mark.parametrize("rows,cols,B,expect", [
    (3, 7, 4096, 8),         # tiny tile: the batch sets the block
    (7, 3, 100_000, 128),    # tiny tile, big batch: the tile caps it
    (16, 20, 4096, 8),
    (16, 32, 4096, 8),       # widest gated tile
    (32, 64, 4096, 2),       # wider than the gate: registers set the block
    (5, 5, 3, 8),
])
def test_lane_block_choice(rows, cols, B, expect):
    lb = pbq.lane_block(rows, cols, B)
    assert lb == expect
    assert lb & (lb - 1) == 0                       # power of two
    assert lb * pbq._pow2(rows) * pbq._pow2(cols) <= max(
        pbq.TILE_ELEMS, pbq._pow2(rows) * pbq._pow2(cols))


def test_batched_cpqr_largest_gated_shape():
    """The widest shape the gate admits (kmax = MAX_KMAX, rows * cols =
    MAX_ELEMS), with a lane block that does not divide B."""
    rows, cols = pbq.MAX_KMAX, pbq.MAX_ELEMS // pbq.MAX_KMAX
    assert min(rows, cols) == pbq.MAX_KMAX
    B = 5
    assert B % pbq.lane_block(rows, cols, B)
    rng = np.random.default_rng(7)
    M = jnp.asarray(rng.normal(size=(B, rows, cols)), jnp.float32)
    f1 = pbq.cpqr_blocked_batched(M, interpret=True)
    f2 = jax.vmap(lambda m: cpqr_blocked(m))(M)
    col_scale = float(jnp.max(jnp.linalg.norm(M, axis=1)))
    _assert_cpqrf_close(f1, f2, atol=5e-5 * col_scale)
