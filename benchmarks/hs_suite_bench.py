"""Full Hock-Schittkowski suite %-matched-optima measurement.

Runs all 28 suite problems from their standard starting points in ONE
fused heterogeneous launch (parallel/hetero.py — one compile for the
whole suite) at the requested dtype, and prints ONE JSON line:

    {"dtype": "f32", "matched": 22, "total": 28, "misses": [...]}

This is BASELINE.json's headline accuracy metric ("% matched optima vs
Enlsip within first-order tolerance"; reference accuracy target:
/root/reference/docs/src/tutorial.md:126-128).  Every miss is
oracle-adjudicated in tests/test_hs_suite.py: the reference-derived
numpy oracle produces the same outcome from the same start at the same
evaluation precision (alternate stationary points hs2/hs13, abnormal
exits hs16/hs27, and at f32 the precision-limited hs30/hs57).

Usage: python benchmarks/hs_suite_bench.py {f32|f64}
(f64 requires x64: JAX_ENABLE_X64=1 in the environment, or a scoped
``jax.enable_x64(True)`` as bench.py uses when it calls :func:`run`).
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo)
from enlsip_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

MATCH_RTOL = 1e-5


def run(dtype_name: str) -> dict:
    from enlsip_tpu.core.types import Options, Tols
    from enlsip_tpu.parallel.hetero import fuse_families, solve_suite_fused
    from enlsip_tpu.parallel.suite import hs_scenario_batch
    from enlsip_tpu.problems import HS_PROBLEMS

    dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    if dtype_name == "f64" and not jax.config.jax_enable_x64:
        raise RuntimeError("f64 suite needs JAX_ENABLE_X64=1")

    def _tols(dt):
        eps = float(jnp.finfo(dt).eps)
        rel = float(np.sqrt(eps))
        return Tols(*(jnp.asarray(v, dt)
                      for v in (1e-10, rel, rel, rel, rel)))

    names = sorted(HS_PROBLEMS)
    # per_family=1, scale=0.0: exactly the published standard starts.
    fams = hs_scenario_batch(names, per_family=1, scale=0.0)
    fused = fuse_families(fams)
    t0 = time.time()
    out = solve_suite_fused(fams, Options(), _tols, dtype=dtype, fused=fused)
    jax.block_until_ready(out[names[0]].f)
    dt = time.time() - t0
    misses = []
    for n in names:
        f, fstar = float(out[n].f[0]), fams[n].fstar
        if not abs(f - fstar) <= MATCH_RTOL * (1 + abs(fstar)):
            misses.append(n)
    result = {"dtype": dtype_name, "matched": len(names) - len(misses),
              "total": len(names), "misses": misses,
              "wall_seconds": round(dt, 1)}

    if dtype_name == "f32" and misses:
        # Hybrid escalation: re-solve the non-matched /
        # non-converged lanes at f64 in one follow-up launch.  The mask
        # route is used (not the exit-code rule) because the f32
        # precision-limited families (hs30/hs57) terminate POSITIVE at
        # the f32-evaluation optimum — only fstar knowledge flags them.
        from enlsip_tpu.parallel.batch import solve_batched
        mask = np.zeros(fused.x0.shape[0], bool)
        for i, n in enumerate(names):
            ec = int(out[n].exit_code[0])
            if n in misses or ec <= 0:
                mask[fused.slices[n]] = True
        res = solve_batched(fused.fns, fused.x0, fused.dims, Options(),
                            _tols(dtype), dtype=dtype, data=fused.data,
                            rdims=fused.rdims, escalate_mask=mask)
        misses_esc = []
        for i, n in enumerate(names):
            f, fstar = float(res.f[fused.slices[n]][0]), fams[n].fstar
            if not abs(f - fstar) <= MATCH_RTOL * (1 + abs(fstar)):
                misses_esc.append(n)
        result["matched_escalated"] = len(names) - len(misses_esc)
        result["misses_escalated"] = misses_esc
        result["escalated_lanes"] = int(mask.sum())

    still = result.get("misses_escalated", result["misses"])
    if dtype_name == "f32" and still:
        result.update(_multistart(still, dtype, _tols,
                                  total=result["total"]))
    return result


def _multistart(still, dtype, _tols, total, K=32):
    """Multistart escalation: the reference is a
    single-start solver, so its published outcomes on
    hs2/hs13/hs16/hs27 (alternate stationary points / abnormal exits,
    oracle-adjudicated in PARITY.md) are its ceiling.  The batched
    framework re-solves a missed family from K perturbed starts in ONE
    fused launch (lane 0 = the standard start).  A family matches if
    ANY converged lane (exit_code > 0 — the termination lattice
    negates codes at infeasible points, enlsip_functions.jl:2471-2481)
    hits the published optimum.  Scoring by "best feasible f" would be
    wrong: on hs13 tolerance-feasible lanes report f slightly BELOW
    f*=1.0 (the constraint boundary is degenerate there), so the best
    lane undercuts the optimum it actually converged to.  Families
    still missing after the f32 pass are re-solved at f64 via the
    escalation path (opt-in; reported as *_multistart fields).

    The user-facing single-problem form of this machinery is
    enlsip_tpu.parallel.multistart.solve_multistart; this bench drives
    the fused multi-family variant so the whole miss set costs one
    launch."""
    from enlsip_tpu.core.types import Options
    from enlsip_tpu.parallel.batch import solve_batched
    from enlsip_tpu.parallel.hetero import fuse_families, solve_suite_fused
    from enlsip_tpu.parallel.suite import hs_scenario_batch
    from enlsip_tpu.problems import get_problem

    fams = hs_scenario_batch(still, per_family=K, scale=1.0)
    for n in list(fams):
        x0 = np.asarray(get_problem(n)[0]["starting_point"], dtype=float)
        xb = np.asarray(fams[n].x0_batch).copy()
        xb[0] = x0
        fams[n] = fams[n]._replace(x0_batch=jnp.asarray(xb))
    fused = fuse_families(fams)
    out = solve_suite_fused(fams, Options(), _tols, dtype=dtype,
                            fused=fused)

    def any_hit(f, ec, fstar):
        f, ec = np.asarray(f, float), np.asarray(ec)
        ok = (ec > 0) & (np.abs(f - fstar) <= MATCH_RTOL * (1 + abs(fstar)))
        return bool(ok.any())

    misses_ms = [n for n in still
                 if not any_hit(out[n].f, out[n].exit_code, fams[n].fstar)]
    if misses_ms:  # f64 re-solve of the still-missed families' lanes
        mask = np.zeros(fused.x0.shape[0], bool)
        for n in misses_ms:
            mask[fused.slices[n]] = True
        res = solve_batched(fused.fns, fused.x0, fused.dims, Options(),
                            _tols(dtype), dtype=dtype, data=fused.data,
                            rdims=fused.rdims, escalate_mask=mask)
        misses_ms = [n for n in misses_ms
                     if not any_hit(res.f[fused.slices[n]],
                                    res.exit_code[fused.slices[n]],
                                    fams[n].fstar)]
    return {"matched_multistart": total - len(misses_ms),
            "misses_multistart": misses_ms,
            "multistart_k": K}


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1] if len(sys.argv) > 1 else "f32")))
