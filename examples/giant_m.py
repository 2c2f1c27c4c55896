"""Giant-m: millions of residual rows on one device (or a mesh).

A 100-parameter data-fit with the residual axis scaled to 2,000,000
rows and inequality constraints active at the solution.  Everything
row-shaped (rx, J, and every derived product) is a GEMM-class stream;
the J2 panel factorization takes the CholeskyQR tall path
(ops/tsqr.CholQRF, Options.tall_qr default) and the line search rides
cached rays via the directional-residual hook (Functions.res_trial:
r(x) = phi(W@x), so each trial is O(m) instead of an O(m*n) stream).

The reference is single-process dense LAPACK
(/root/reference/src/enlsip_functions.jl:223); the row-sharded variant
of this configuration (parallel/rowsharded.solve_rowsharded) runs the
same solver over a device mesh — see __graft_entry__.dryrun_multichip
layouts 2/3.

Run:  python examples/giant_m.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax

from enlsip_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from enlsip_tpu.core.driver import Functions, init_carry, run_chunk
from enlsip_tpu.core.types import Dims, Options, Tols

M, N, L = 2_000_000, 100, 20


def main():
    rng = np.random.default_rng(0)
    W = jnp.asarray(rng.normal(size=(M, N)).astype(np.float32) / np.sqrt(N))
    xtrue = rng.normal(size=N).astype(np.float32)
    z = np.asarray(W) @ xtrue
    Y = jnp.asarray(z + 0.1 * np.tanh(z)
                    + 0.01 * rng.normal(size=M).astype(np.float32))
    blo = jnp.asarray(xtrue[:5] + 0.2)  # cuts off the unconstrained optimum

    dims = Dims(n=N, m=M, q=0, l=L)
    opts = Options(second_derivatives=False, max_iter=30)
    rel = float(np.sqrt(np.finfo(np.float32).eps))
    tols = Tols(*(jnp.float32(v) for v in (1e-10, rel, rel, rel, rel)))

    def cons(x):
        return jnp.concatenate([x[:5] - blo, x[5:L - 1] + 5.0,
                                jnp.array([4.0 * N - jnp.dot(x, x)])])

    @jax.jit
    def solve(W, Y, x0):
        def res(x):
            u = W @ x
            return Y - (u + 0.1 * jnp.tanh(u))

        def jac(x):
            u = W @ x
            return -(1.0 + 0.1 * (1.0 - jnp.tanh(u) ** 2))[:, None] * W

        def res_trial(x, p):
            # one W pass for both ray endpoints ((n, 2) rhs)
            zxp = W @ jnp.stack([x, p], axis=1)
            zx, zp = zxp[:, 0], zxp[:, 1]

            def at(a):
                u = zx + a.astype(zx.dtype) * zp
                return Y - (u + 0.1 * jnp.tanh(u))

            return at

        def rowscale(x):
            # Factored J = diag(rowscale) @ W: J is never materialized
            # (the fused WY kernel streams W with the scale applied
            # in-kernel) — two (m, n) HBM streams fewer per iteration.
            u = W @ x
            return -(1.0 + 0.1 * (1.0 - jnp.tanh(u) ** 2))

        fns = Functions(res=res, jac_res=jac, cons=cons,
                        jac_cons=jax.jacfwd(cons), res_trial=res_trial,
                        jac_rowscale=rowscale, jac_base=lambda: W)
        c = init_carry(fns, x0, dims, opts, jnp.float32)
        c = run_chunk(c, fns, dims, opts, tols, opts.max_iter + 1)
        return c.x, c.nb_iter, c.exit_code, jnp.sum(c.active_mask), \
            jnp.dot(c.rx, c.rx)

    x0 = jnp.zeros(N, jnp.float32)
    out = solve(W, Y, x0)            # compile + run
    np.asarray(out[0])
    t0 = time.perf_counter()
    x, n_iter, exit_code, t_act, f = solve(W, Y, x0)
    np.asarray(x)
    dt = time.perf_counter() - t0
    print(f"{M:,} rows x {N} params, {L} constraints: "
          f"{int(n_iter)} GN iterations in {dt:.2f} s "
          f"({int(n_iter)/dt:.1f} iters/s), exit {int(exit_code)}, "
          f"{int(t_act)} active constraints, f = {float(f):.4f}")
    err = float(jnp.linalg.norm(x - jnp.asarray(xtrue)) /
                jnp.linalg.norm(jnp.asarray(xtrue)))
    print(f"parameter recovery ||x - x_true||/||x_true|| = {err:.3f} "
          f"(constrained: the first 5 coordinates sit at their bounds)")


if __name__ == "__main__":
    main()
