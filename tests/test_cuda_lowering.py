"""The Triton-route kernel lowers for CUDA on a machine without a GPU.

``lower(lowering_platforms=("cuda",))`` runs the Pallas-to-Triton
lowering here, so a primitive the Triton route cannot take fails on the
CPU instead of on the card.  Compiling and running the lowered kernel
needs the card: chip_smoke.py's kernels and timing phases do that.
"""

import jax
import jax.numpy as jnp
import pytest

from enlsip_tpu.ops import blocked_qr as bq
from enlsip_tpu.ops import pallas_batched_qr as pbq

TRITON_CALL = "__gpu$xla.gpu.triton"


def _lower_cuda(fn, *args):
    # A fresh wrapper per call: the dispatch gates are read at trace time.
    return jax.jit(lambda *a: fn(*a)).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("B,rows,cols", [
    (4096, 3, 7), (4096, 7, 3), (4096, 16, 32), (1, 5, 5), (100_000, 13, 5),
])
def test_batched_cpqr_lowers_for_cuda(B, rows, cols):
    M = jax.ShapeDtypeStruct((B, rows, cols), jnp.float32)
    text = _lower_cuda(pbq.cpqr_blocked_batched, M)
    assert text.count(TRITON_CALL) == 1
    assert "cpqr_batched" in text


def test_vmapped_solver_cpqr_dispatches_to_triton(monkeypatch):
    """Under vmap on the GPU backend the solver's small CPQR becomes one
    Triton kernel call; on the CPU it stays the XLA loop."""
    M = jax.ShapeDtypeStruct((512, 7, 3), jnp.float32)

    def solver_cpqr(M):
        return jax.vmap(lambda m: bq.cpqr_blocked(m, nsteps=2))(M)

    assert TRITON_CALL not in _lower_cuda(solver_cpqr, M)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _lower_cuda(solver_cpqr, M).count(TRITON_CALL) == 1
