"""Benchmark harness: prints ONE JSON line, measured on a GPU.

Headline metric: Chained Rosenbrock n=1000 solve wall time (steady
state, compile excluded; the reference's number is BenchmarkTools
@btime, which also excludes compilation; docs/src/tutorial.md:301,
baseline 2.325 s).  vs_baseline = baseline_seconds / our_seconds
(speedup, >1 is better).

Secondary metrics ride along as extra JSON fields: batched-HS65
throughput (solves/s) with % matched optima, and giant-m (5M residual
rows, constraints active at the solution) GN iteration rate.  Every run
records the device (platform, kind, count) and the card's name and
power limit.  Without a GPU the harness exits non-zero; a section that
fails fails the run.

Usage: python bench.py
"""

from __future__ import annotations

import json
import os as _os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

_REPO = _os.path.dirname(_os.path.abspath(__file__))
sys.path[:0] = [_REPO, _os.path.join(_REPO, "tests"),
                _os.path.join(_REPO, "benchmarks")]

from enlsip_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

BASELINE_CR1000_S = 2.325


def _tols(dtype):
    from enlsip_tpu.core.types import Tols
    eps = float(jnp.finfo(dtype).eps)
    rel = float(np.sqrt(eps))
    return Tols(*(jnp.asarray(v, dtype) for v in (1e-10, rel, rel, rel, rel)))


def bench_chained_rosenbrock(n=1000, dtype=jnp.float32, repeats=3):
    """Steady-state solve time; the model (and its cached closures) is
    reused across repeats exactly as the reference's @btime re-solves
    one problem."""
    import enlsip_tpu as et
    from problems import chained_rosenbrock

    model = et.CnlsModel(**chained_rosenbrock(n))
    times = []
    status = None
    for _ in range(repeats + 1):  # first solve includes compile; drop it
        t0 = time.perf_counter()
        et.solve(model, dtype=dtype)
        times.append(time.perf_counter() - t0)
        status = et.status(model)
    return min(times[1:]), status


def bench_small_n(dtype=jnp.float32, repeats=5):
    """Single-solve latency at the reference tutorial's small sizes
    (docs/src/tutorial.md:299-300: 3.616e-4 s at n=10, 3.322e-2 s at
    n=100 for Enlsip.jl).  Measured steady-state like
    the reference's @btime (compile excluded)."""
    import enlsip_tpu as et
    from problems import chained_rosenbrock

    out = {}
    for n, ref_s in ((10, 3.616e-4), (100, 3.322e-2)):
        model = et.CnlsModel(**chained_rosenbrock(n))
        times = []
        for _ in range(repeats + 1):  # first includes compile; drop it
            t0 = time.perf_counter()
            et.solve(model, dtype=dtype)
            times.append(time.perf_counter() - t0)
        best = min(times[1:])
        out[f"small_n{n}_solve_seconds"] = round(best, 5)
        out[f"small_n{n}_vs_reference"] = round(ref_s / best, 3)

    # The supported recipe for many small problems: ONE launch, B
    # independent lanes (tutorial "batched small problems" section):
    # the per-launch overhead is shared by every lane.
    out.update(_small_n_batched(dtype=dtype))
    return out


def _small_n_batched(B=1024, n=10, ref_s=3.616e-4, dtype=jnp.float32):
    import enlsip_tpu as et
    from enlsip_tpu.core.driver import Functions
    from enlsip_tpu.core.types import Dims, Options
    from enlsip_tpu.models.model import (_model_functions,
                                         total_nb_constraints)
    from enlsip_tpu.parallel import solve_batched
    from problems import chained_rosenbrock

    kw = chained_rosenbrock(n)
    model = et.CnlsModel(**kw)
    res_fn, jac_res, cons, jac_cons = _model_functions(model, dtype)
    fns = Functions(res=res_fn, jac_res=jac_res, cons=cons,
                    jac_cons=jac_cons)
    dims = Dims(n=n, m=model.nb_residuals, q=model.nb_eqcons,
                l=total_nb_constraints(model))
    rng = np.random.default_rng(0)
    x0 = np.asarray(kw["starting_point"], float)
    starts = x0[None, :] + 0.1 * rng.normal(size=(B, n))
    tols = _tols(dtype)

    res = solve_batched(fns, starts, dims, Options(), tols, dtype=dtype)
    np.asarray(res.f)  # compile + run
    t0 = time.perf_counter()
    res = solve_batched(fns, starts, dims, Options(), tols, dtype=dtype)
    f = np.asarray(res.f)
    dt = time.perf_counter() - t0
    per = dt / B
    ok = float(np.mean(np.asarray(res.exit_code) > 0))
    return {
        "small_n10_batched_lanes": B,
        "small_n10_batched_per_solve_seconds": round(per, 7),
        "small_n10_batched_per_solve_vs_reference": round(ref_s / per, 1),
        "small_n10_batched_converged_rate": round(ok, 4),
    }


def bench_cr5000(dtype=jnp.float32):
    """CR n=5000 both ways on the per-solve precision knob: default
    IEEE-f32 GEMMs vs opt-in bf16 passes.  The reference's analogue is
    its generic element type T (solver.jl:62)."""
    import enlsip_tpu as et
    from problems import chained_rosenbrock

    model = et.CnlsModel(**chained_rosenbrock(5000))
    out = {}
    for label, prec in (("default", "float32"), ("bf16", "bfloat16")):
        times, status = [], None
        for _ in range(2):  # first includes compile; keep the second
            t0 = time.perf_counter()
            et.solve(model, dtype=dtype, matmul_precision=prec)
            times.append(time.perf_counter() - t0)
            status = et.status(model)
        out[label] = {"seconds": round(times[-1], 3), "status": str(status)}
    return out


def bench_batched_hs65(B=512, dtype=jnp.float32):
    import enlsip_tpu as et
    from enlsip_tpu.core.driver import Functions
    from enlsip_tpu.core.types import Dims, Options
    from enlsip_tpu.models.model import build_constraint_functions
    from enlsip_tpu.parallel import solve_batched
    from problems import HS65, HS65_FSTAR

    model = et.CnlsModel(**HS65)
    from enlsip_tpu.models.model import _model_functions
    res_fn, jac_res, cons, jac_cons = _model_functions(model, dtype)
    fns = Functions(res=res_fn, jac_res=jac_res, cons=cons,
                    jac_cons=jac_cons)
    dims = Dims(n=3, m=3, q=0, l=7)
    rng = np.random.default_rng(0)
    x0 = np.asarray(HS65["starting_point"])
    starts = x0[None, :] + 0.3 * rng.normal(size=(B, 3))
    tols = _tols(dtype)

    res = solve_batched(fns, starts, dims, Options(), tols, dtype=dtype)
    np.asarray(res.f)  # sync (compile + run)
    t0 = time.perf_counter()
    res = solve_batched(fns, starts, dims, Options(), tols, dtype=dtype)
    f = np.asarray(res.f)  # sync
    dt = time.perf_counter() - t0
    ok = np.asarray(res.exit_code) > 0
    matched = np.abs(f - HS65_FSTAR) < 1e-4
    return B / dt, float(np.mean(matched)), float(np.mean(ok & matched))


# ------------------- ODE-fit batched (module-level for fn identity) ---

def _ode_res(x, y):
    from enlsip_tpu.problems import ode_fit
    return ode_fit.residuals_data(x, y)


def _ode_jac(x, y):
    from enlsip_tpu.problems import ode_fit
    return jax.jacfwd(ode_fit.residuals_data)(x, y)


_ODE_CONS = {}


def _ode_cons(x, y):
    return _ODE_CONS["cons"](x)


def _ode_jac_cons(x, y):
    return _ODE_CONS["jac"](x)


def bench_ode_fit_batched(B=10_000, dtype=jnp.float32):
    """10k-instance batched parameter estimation with PER-LANE noisy
    observations (BASELINE configs[3] single-chip slice; the data= API)."""
    import enlsip_tpu as et
    from enlsip_tpu.core.driver import Functions
    from enlsip_tpu.core.types import Dims, Options
    from enlsip_tpu.models.model import (build_constraint_functions,
                                         total_nb_constraints)
    from enlsip_tpu.parallel import solve_batched
    from enlsip_tpu.problems import ode_fit

    model = et.CnlsModel(**ode_fit.model_kwargs())
    if not _ODE_CONS:
        cons, jac = build_constraint_functions(model)
        _ODE_CONS["cons"] = cons
        _ODE_CONS["jac"] = jac
    fns = Functions(res=_ode_res, jac_res=_ode_jac, cons=_ode_cons,
                    jac_cons=_ode_jac_cons)
    dims = Dims(n=model.nb_parameters, m=model.nb_residuals, q=0,
                l=total_nb_constraints(model))
    opts = Options(second_derivatives=False)
    tols = _tols(dtype)
    starts = ode_fit.perturbed_starts(B)
    ys = ode_fit.scenario_observations(B).astype(np.float32)

    res = solve_batched(fns, starts, dims, opts, tols, dtype=dtype, data=ys)
    np.asarray(res.f)  # sync (compile + run)
    t0 = time.perf_counter()
    res = solve_batched(fns, starts, dims, opts, tols, dtype=dtype, data=ys)
    f = np.asarray(res.f)  # sync
    dt = time.perf_counter() - t0
    # Miss breakdown by exit code: the non-optimum
    # lanes are (a) -6 at iteration ~1 — genuinely non-descent first GN
    # direction from that start at f32 evaluation noise, (b) -4 — the
    # lane requests a Newton step under this GN-only throughput config,
    # (c) positive codes — legitimate alternate local minima of the
    # 5-exponential fit.
    ec = np.asarray(res.exit_code)
    miss = f >= 1e-3
    codes, counts = np.unique(ec[miss], return_counts=True)
    breakdown = {int(c): int(k) for c, k in zip(codes, counts)}
    strict = float(np.mean(~miss & (ec > 0)))
    # Hybrid escalation: re-solve the non-matched /
    # non-converged residue at f64 (one follow-up launch over the ~tens
    # of flagged lanes) and report the escalated strict rate.
    strict_esc, n_esc = strict, 0
    esc_mask = miss | (ec <= 0)
    if esc_mask.any():
        res_e = solve_batched(fns, starts, dims, opts, tols, dtype=dtype,
                              data=ys, escalate_mask=esc_mask)
        f_e = np.asarray(res_e.f)
        ec_e = np.asarray(res_e.exit_code)
        strict_esc = float(np.mean((f_e < 1e-3) & (ec_e > 0)))
        n_esc = int(esc_mask.sum())
    return (B / dt, float(np.mean(~miss)), strict, breakdown, strict_esc,
            n_esc)


def bench_hetero_suite(per_family=512, dtype=jnp.float32, names=None,
                       second_derivatives=False):
    """Mixed-(n, m, q, l) HS families in ONE fused jitted launch
    (parallel/hetero.py) — the heterogeneous scenario-batch config.

    The default family set converges under GN-only from perturbed
    starts; pass ``second_derivatives=True`` (and include hs42) for the
    fused-Newton regime row."""
    from enlsip_tpu.core.types import Options
    from enlsip_tpu.parallel.hetero import solve_suite_fused
    from enlsip_tpu.parallel.suite import hs_scenario_batch

    from enlsip_tpu.parallel.hetero import fuse_families

    # Five families with genuinely distinct (n, m, q, l): n 2-5, m 2-4,
    # q 0-3, l 1-13.
    if names is None:
        names = ["hs14", "hs65", "hs26", "hs53", "hs79"]
    fams = hs_scenario_batch(names, per_family=per_family, seed=0)
    B = sum(f.x0_batch.shape[0] for f in fams.values())
    opts = Options(max_iter=60, second_derivatives=second_derivatives)

    # The union closures are the jit cache key: build them ONCE so the
    # measured call reuses the compiled executable.
    fused = fuse_families(fams)
    out = solve_suite_fused(fams, opts, _tols, dtype=dtype, fused=fused)
    np.asarray(out[names[0]].f)  # sync (compile + run)
    t0 = time.perf_counter()
    out = solve_suite_fused(fams, opts, _tols, dtype=dtype, fused=fused)
    fvals = {k: np.asarray(v.f) for k, v in out.items()}
    dt = time.perf_counter() - t0
    matched = []
    for name, fam in fams.items():
        if fam.fstar is not None:
            matched.append(np.abs(fvals[name] - fam.fstar)
                           < 1e-3 * max(1.0, abs(fam.fstar)))
    match_rate = float(np.mean(np.concatenate(matched))) if matched else None
    return B / dt, match_rate, (fused, opts, dtype)


def bench_hetero_100k(dtype=jnp.float32):
    """The scenario batch at design-point scale on ONE device: 100k
    mixed lanes (BASELINE configs[3] names 1M lanes across devices; the
    1M-lane sharded layout runs in ``chip_smoke.py --four``).  Returns
    (solves/s, match_rate, peak device memory in GiB)."""
    rate, match, _ = bench_hetero_suite(per_family=20_000, dtype=dtype)
    stats = jax.devices()[0].memory_stats()
    return rate, match, round(stats["peak_bytes_in_use"] / 2**30, 3)


def bench_hetero_newton(per_family=512, dtype=jnp.float32):
    """The HARD hetero regime: second_derivatives=True including hs42,
    whose perturbed lanes genuinely request fused-Newton steps under
    per-lane RDims (the path tests/test_hetero.py exercises at B=8)."""
    rate, match, _ = bench_hetero_suite(
        per_family=per_family, dtype=dtype,
        names=["hs14", "hs65", "hs26", "hs53", "hs79", "hs42"],
        second_derivatives=True)
    return rate, match


# --------------------------- giant-m (module-level for fn identity) ---

_GM_M, _GM_N, _GM_L = 5_000_000, 100, 50
_GM = {}


def _gm_init():
    """Eagerly build the giant-m data OUTSIDE any trace (the closures
    below only read the finished arrays)."""
    if not _GM:
        rng = np.random.default_rng(3)
        W = np.asarray(rng.normal(size=(_GM_M, _GM_N)),
                       np.float32) / np.sqrt(_GM_N)
        xtrue = rng.normal(size=(_GM_N,)).astype(np.float32)
        z = W @ xtrue
        Y = z + 0.1 * np.tanh(z) + 0.01 * rng.normal(
            size=(_GM_M,)).astype(np.float32)
        _GM["W"] = jnp.asarray(W)
        _GM["Y"] = jnp.asarray(Y)
        # First 5 inequalities x_j >= xtrue_j + 0.2 cut off the
        # unconstrained optimum, so the solve terminates with t >= 5
        # ACTIVE constraints (the working-set machinery is exercised at
        # scale, not just unconstrained GN).  Most are also violated at
        # x0 = 0 and enter the initial working set.
        _GM["blo"] = jnp.asarray(xtrue[:5] + 0.2)


def _gm_cons(x):
    return jnp.concatenate([
        x[:5] - _GM["blo"],
        x[5: _GM_L - 1] + 5.0,
        jnp.array([float(_GM_N) * 4.0 - jnp.dot(x, x)])])


def bench_giant_m(dtype=jnp.float32, max_iter=8, trace_dir=None):
    """GN iterations/s on a 5M-row (BASELINE spec scale) dense problem with active
    constraints at the solution (single chip; the row-sharded
    multi-chip variant runs the same code over a mesh — see
    parallel/rowsharded.py and the TSQR dryrun layout).

    The 2 GB data arrays enter as jit ARGUMENTS (the problem closures
    are built over tracers inside the jitted solve) — closing over
    concrete arrays would bake them into the HLO as constants and choke
    compilation.

    Precision contract: this drives run_chunk raw, so it scopes
    ``matmul_precision_scope(opts)`` exactly as ``solve`` and
    ``solve_batched`` do (core/types.py).  Reduced-precision GEMM passes
    perturb d1sq enough to flip the exit class from +10000
    (relative-residual convergence) to +40 (noise-limited step)."""
    from enlsip_tpu.core.driver import Functions, init_carry, run_chunk
    from enlsip_tpu.core.types import (Dims, Options,
                                       matmul_precision_scope)

    _gm_init()
    dims = Dims(n=_GM_N, m=_GM_M, q=0, l=_GM_L)
    opts = Options(second_derivatives=False, max_iter=max_iter)
    tols = _tols(dtype)

    @jax.jit
    def gm_solve(W, Y, x0, tols):
        def res(x):
            z = W @ x
            return Y - (z + 0.1 * jnp.tanh(z))

        def jac(x):
            z = W @ x
            return -(1.0 + 0.1 * (1.0 - jnp.tanh(z) ** 2))[:, None] * W

        def res_trial(x, p):
            # r(x) = phi(W@x): every line-search trial rides the ray
            # W@x + a*(W@p) — O(m) per trial instead of an O(m*n)
            # stream of W (Functions.res_trial contract).  Both ray
            # endpoints come from ONE W pass ((n, 2) rhs) instead of
            # two matvecs.
            zxp = W @ jnp.stack([x, p], axis=1)      # (m, 2)
            zx, zp = zxp[:, 0], zxp[:, 1]

            def at(a):
                u = zx + a.astype(zx.dtype) * zp
                return Y - (u + 0.1 * jnp.tanh(u))

            return at

        def rowscale(x):
            # Factored J = diag(rowscale) @ W (Functions.jac_* hook): J
            # is never materialized; the WY apply runs on W and the
            # scale is applied to its result.
            z = W @ x
            return -(1.0 + 0.1 * (1.0 - jnp.tanh(z) ** 2))

        fns = Functions(res=res, jac_res=jac, cons=_gm_cons,
                        jac_cons=jax.jacfwd(_gm_cons), res_trial=res_trial,
                        jac_rowscale=rowscale, jac_base=lambda: W)
        c = init_carry(fns, x0, dims, opts, dtype)
        c = run_chunk(c, fns, dims, opts, tols, opts.max_iter + 1)
        return c.x, c.nb_iter, c.exit_code, jnp.sum(c.active_mask)

    x0 = jnp.zeros(_GM_N, dtype)
    W, Y = _GM["W"], _GM["Y"]
    with matmul_precision_scope(opts):
        x, n_iter, exit_code, t_act = gm_solve(W, Y, x0, tols)  # compile
        np.asarray(x)
        if trace_dir is not None:  # op-level attribution
            with jax.profiler.trace(trace_dir):
                x, n_iter, exit_code, t_act = gm_solve(W, Y, x0, tols)
                np.asarray(x)
        t0 = time.perf_counter()
        x, n_iter, exit_code, t_act = gm_solve(W, Y, x0, tols)
        np.asarray(x)
        dt = time.perf_counter() - t0
        # XLA's own peak-memory accounting of the solve executable (the
        # factored path holds no dense J).
        ma = gm_solve.lower(W, Y, x0, tols).compile().memory_analysis()
        peak_gb = round(ma.peak_memory_in_bytes / 2**30, 2)
    n_iter = int(n_iter)
    return max(n_iter, 1) / dt, n_iter, int(exit_code), int(t_act), peak_gb


def bench_hs_suite(dtype_name: str) -> dict:
    """Full 28-problem HS suite %-matched-optima (BASELINE's headline
    accuracy metric), one fused launch for the whole suite, in this
    process (benchmarks/hs_suite_bench.py); f64 runs under a scoped
    x64 context so the f32 sections keep their dtype policy."""
    import hs_suite_bench
    if dtype_name == "f64":
        with jax.enable_x64(True):
            return hs_suite_bench.run("f64")
    return hs_suite_bench.run(dtype_name)


def card() -> dict:
    """The device JAX reports, and the card's name and power limit."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX reports "
                         f"{devs[0].platform} devices")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi}


OUT = {
    "metric": "chained_rosenbrock_n1000_solve_seconds",
    "value": None,
    "unit": "s",
    "vs_baseline": None,
    "sections_done": [],
}


# ------------------------------------------------------------ sections

def _sec_cr1000():
    t_cr, status = bench_chained_rosenbrock()
    OUT["value"] = round(t_cr, 4)
    OUT["vs_baseline"] = round(BASELINE_CR1000_S / t_cr, 3)
    OUT["cr1000_status"] = status


def _sec_small_n():
    OUT.update(bench_small_n())


def _sec_cr5000():
    cr5000 = bench_cr5000()
    OUT["cr5000_default_seconds"] = cr5000.get("default", {}).get(
        "seconds", cr5000.get("error"))
    OUT["cr5000_bf16_seconds"] = cr5000.get("bf16", {}).get("seconds")
    OUT["cr5000_default_status"] = cr5000.get("default", {}).get("status")
    OUT["cr5000_bf16_status"] = cr5000.get("bf16", {}).get("status")


def _sec_giant_m():
    gm_rate, gm_iters, gm_exit, gm_t, gm_peak = bench_giant_m()
    OUT["giant_m_5m_iters_per_sec"] = round(gm_rate, 2)
    OUT["giant_m_iters"] = gm_iters
    OUT["giant_m_exit"] = gm_exit
    OUT["giant_m_active_t"] = gm_t
    OUT["giant_m_peak_hbm_gb"] = gm_peak


def _sec_hs65():
    hs_rate, hs_match, hs_strict = bench_batched_hs65()
    OUT["hs65_batched_solves_per_sec"] = round(hs_rate, 1)
    OUT["hs65_batched_match_rate"] = round(hs_match, 4)
    OUT["hs65_batched_match_and_converged_rate"] = round(hs_strict, 4)
    hs4k_rate, hs4k_match, _ = bench_batched_hs65(B=4096)
    OUT["hs65_batched_4096_solves_per_sec"] = round(hs4k_rate, 1)
    OUT["hs65_batched_4096_match_rate"] = round(hs4k_match, 4)


def _sec_hetero():
    het_rate, het_match, _ = bench_hetero_suite()
    OUT["hetero_suite_solves_per_sec"] = round(het_rate, 1)
    OUT["hetero_suite_match_rate"] = (round(het_match, 4)
                                      if isinstance(het_match, float)
                                      else het_match)


def _sec_ode():
    (ode_rate, ode_opt, ode_strict, ode_breakdown, ode_strict_esc,
     ode_n_esc) = bench_ode_fit_batched()
    OUT["ode_fit_10k_solves_per_sec"] = round(ode_rate, 1)
    OUT["ode_fit_10k_optimum_rate"] = (round(ode_opt, 4)
                                       if isinstance(ode_opt, float)
                                       else ode_opt)
    OUT["ode_fit_10k_match_and_converged_rate"] = (
        round(ode_strict, 4) if isinstance(ode_strict, float)
        else ode_strict)
    OUT["ode_fit_10k_miss_exit_codes"] = (
        {str(k): v for k, v in ode_breakdown.items()}
        if isinstance(ode_breakdown, dict) else ode_breakdown)
    OUT["ode_fit_10k_strict_escalated"] = (
        round(ode_strict_esc, 4) if isinstance(ode_strict_esc, float)
        else ode_strict_esc)
    OUT["ode_fit_10k_escalated_lanes"] = ode_n_esc


def _sec_hs_suite_f32():
    r = bench_hs_suite("f32")
    OUT["hs_suite_match_f32"] = r.get("matched")
    OUT["hs_suite_match_f32_escalated"] = r.get("matched_escalated")
    OUT["hs_suite_misses_f32_escalated"] = r.get("misses_escalated")
    OUT["hs_suite_misses_f32"] = r.get("misses")
    OUT["hs_suite_total"] = r.get("total")
    OUT["hs_suite_match_multistart"] = r.get("matched_multistart")
    OUT["hs_suite_misses_multistart"] = r.get("misses_multistart")


def _sec_hs_suite_f64():
    r = bench_hs_suite("f64")
    OUT["hs_suite_match_f64"] = r.get("matched")
    OUT["hs_suite_misses_f64"] = r.get("misses")
    OUT.setdefault("hs_suite_total", r.get("total"))


def _sec_hetero_100k():
    het100k_rate, het100k_match, het100k_peak = bench_hetero_100k()
    OUT["hetero_100k_solves_per_sec"] = round(het100k_rate, 1)
    OUT["hetero_100k_match_rate"] = (round(het100k_match, 4)
                                     if isinstance(het100k_match, float)
                                     else het100k_match)
    OUT["hetero_100k_peak_hbm_gb"] = het100k_peak


def _sec_hetero_newton():
    hetN_rate, hetN_match = bench_hetero_newton()
    OUT["hetero_newton_solves_per_sec"] = round(hetN_rate, 1)
    OUT["hetero_newton_match_rate"] = (round(hetN_match, 4)
                                       if isinstance(hetN_match, float)
                                       else hetN_match)


SECTIONS = (("cr1000", _sec_cr1000), ("small_n", _sec_small_n),
            ("cr5000", _sec_cr5000), ("giant_m", _sec_giant_m),
            ("hs_suite_f32", _sec_hs_suite_f32), ("hs65_batched", _sec_hs65),
            ("hetero_suite", _sec_hetero), ("ode_fit", _sec_ode),
            ("hetero_100k", _sec_hetero_100k),
            ("hs_suite_f64", _sec_hs_suite_f64),
            ("hetero_newton", _sec_hetero_newton))


def main():
    OUT["device"] = card()
    t_start = time.monotonic()
    for name, fn in SECTIONS:
        t0 = time.monotonic()
        print(f"[bench] start {name}", file=sys.stderr, flush=True)
        fn()
        OUT["sections_done"].append(f"{name}:{time.monotonic() - t0:.0f}s")
    OUT["elapsed_s"] = round(time.monotonic() - t_start, 1)
    print(json.dumps(OUT), flush=True)


if __name__ == "__main__":
    main()
