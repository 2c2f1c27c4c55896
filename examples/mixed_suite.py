"""Mixed problem families in ONE fused launch.

Five Hock–Schittkowski CNLS problems with genuinely different
dimensions (n 2–5, m 2–4, q 0–3, l 1–13) solve together as a single
jitted batch: each family pads to the bucket maxima with masked
residual/constraint rows, and per-lane dimensions select the live
slice (parallel/hetero.py).  The reference solves one instance at a
time (/root/reference/src/enlsip_functions.jl:2776-2878); fusing
heterogeneous scenario batches is this framework's extension.

Run:  python examples/mixed_suite.py
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

from enlsip_tpu.core.types import Options, Tols
from enlsip_tpu.parallel import (fuse_families, hs_scenario_batch,
                                 solve_suite_fused)


def default_tols(dtype):
    eps = float(jnp.finfo(dtype).eps)
    rel = eps ** 0.5
    return Tols(*(jnp.asarray(v, dtype)
                  for v in (1e-10, rel, rel, rel, rel)))


def main():
    names = ["hs14", "hs65", "hs26", "hs53", "hs79"]
    fams = hs_scenario_batch(names, per_family=512, seed=0)
    total = sum(f.x0_batch.shape[0] for f in fams.values())
    opts = Options(max_iter=60, second_derivatives=False)
    fused = fuse_families(fams)

    out = solve_suite_fused(fams, opts, default_tols, fused=fused)
    np.asarray(out[names[0]].f)  # sync (compile + run)
    t0 = time.perf_counter()
    out = solve_suite_fused(fams, opts, default_tols, fused=fused)
    fvals = {k: np.asarray(v.f) for k, v in out.items()}
    dt = time.perf_counter() - t0

    print(f"{total} instances across {len(names)} families in one "
          f"launch: {total / dt:.0f} solves/s")
    for name, fam in fams.items():
        f = fvals[name]
        ok = np.abs(f - fam.fstar) < 1e-3 * max(1.0, abs(fam.fstar))
        print(f"  {name:6s} (n={fam.dims.n}, m={fam.dims.m}, "
              f"q={fam.dims.q}, l={fam.dims.l}): "
              f"{100 * ok.mean():5.1f}% at published optimum "
              f"f* = {fam.fstar:.6g}")


if __name__ == "__main__":
    main()
