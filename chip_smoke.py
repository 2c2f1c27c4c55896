"""Smoke test of the solver on an NVIDIA GPU, through the user entry points.

    python chip_smoke.py           # phases 1-7 on one card
    python chip_smoke.py --four    # the four-card paths and their one-card
                                   # comparisons, nothing else

Phases (one process, one card):

1. device   JAX's devices, the card's name and power limit (nvidia-smi).
2. single   Chained Rosenbrock n=1000 through ``et.solve`` in f32, checked
            against an f64 solve of the same model on the card.
3. batched  HS65 with 4096 lanes through ``solve_batched``, with the fused
            batched CPQR kernel and again with the plain XLA loop.
4. fused    Five HS families, 100k lanes, through ``solve_suite_fused``,
            with the kernel and again with the plain XLA loop.
5. giant    A 5M x 100 constrained fit with a factored Jacobian, checked
            against the same fit with the dense Jacobian.
6. kernels  The batched CPQR kernel against the vmapped XLA loop at real
            widths, plus a probe that tells IEEE f32 arithmetic from TF32.
7. timing   The kernel alone (a loop inside one jit) against what XLA
            makes of the plain version.

Every number printed carries the card's name and power limit.  The last
line of standard output is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed.  Without a GPU, or when any phase
or comparison fails, the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Sizes (phases 3-6).
HS65_LANES = 4096
FUSED_PER_FAMILY = 20_000
FUSED_FAMILIES = ("hs14", "hs65", "hs26", "hs53", "hs79")
GIANT_M, GIANT_N, GIANT_L, GIANT_T = 5_000_000, 100, 50, 5
GIANT_ITERS = 8
# HS shapes, and the widest tile the kernel's gate admits.
CPQR_SHAPES = ((3, 7), (7, 3), (5, 5), (16, 20), (16, 32))
CPQR_LANES = 4096
FOUR_PER_CARD = 250_000
SEED = 0
TIMING_REPS = 3          # median of this many timed runs (after warm-up)
LOOP_ITERS = 20          # kernel calls per timed jit in phase 7

CARD = ""                # "name, power limit" label for every number


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(f"{msg}  [{CARD}]", flush=True)


def median_seconds(fn, reps: int = TIMING_REPS) -> float:
    """Median wall time of ``fn()`` (which must block) after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


@contextlib.contextmanager
def plain_xla():
    """Swap the batched CPQR kernel's dispatch gate for the plain XLA
    loop.  Compiled programs are dropped on entry and exit so the swap
    takes effect on the next trace."""
    import jax

    from enlsip_tpu.ops import blocked_qr
    real = blocked_qr._use_batched_pallas
    blocked_qr._use_batched_pallas = lambda *a: False
    jax.clear_caches()
    try:
        yield
    finally:
        blocked_qr._use_batched_pallas = real
        jax.clear_caches()


def _tols(dtype):
    from enlsip_tpu.core.types import Tols
    return Tols.for_dtype(dtype)


def peak_bytes(device) -> int:
    """Device memory high-water mark of this process's arrays."""
    return device.memory_stats()["peak_bytes_in_use"]


def match_rate(f, fstar) -> "np.ndarray":
    """Lanes at the family's optimum: |f - f*| < 1e-3 max(1, |f*|)."""
    import numpy as np
    return np.abs(np.asarray(f) - fstar) < 1e-3 * max(1.0, abs(fstar))


# ------------------------------------------------------------ phase 1

def phase_device(results):
    global CARD
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX reports {devs[0].platform} devices")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    CARD = out[0].strip()
    print(f"nvidia-smi: {out[0].strip()}", flush=True)
    say(f"jax.devices(): {devs}; device_kind {devs[0].device_kind}")
    results["device"] = {"platform": devs[0].platform,
                         "kind": devs[0].device_kind, "count": len(devs)}


# ------------------------------------------------------------ phase 2

def phase_single(results):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import enlsip_tpu as et
    from problems import chained_rosenbrock

    model = et.CnlsModel(**chained_rosenbrock(1000))
    t = median_seconds(lambda: et.solve(model))
    x32, f32 = et.solution(model), et.sum_sq_residuals(model)
    st32 = et.status(model)
    with jax.enable_x64(True):
        m64 = et.CnlsModel(**chained_rosenbrock(1000))
        et.solve(m64, dtype=jnp.float64)
        x64, f64 = et.solution(m64), et.sum_sq_residuals(m64)
        st64 = et.status(m64)
    dx = float(np.max(np.abs(x32 - x64)))
    df = abs(f32 - f64)
    # f32 stops at its own tolerances (rel_tol = sqrt(eps32) ~ 3.5e-4):
    # agreement to 1e-3 relative in x and f is what f32 can promise.
    x_tol = 1e-3 * max(1.0, float(np.max(np.abs(x64))))
    f_tol = 1e-3 * max(1.0, abs(f64))
    say(f"single: CR n=1000 f32 solve {t:.4f} s (median of "
        f"{TIMING_REPS}), status {st32}; f32 f={f32:.7g} vs f64 "
        f"f={f64:.7g} (status {st64}); max|dx|={dx:.3g} (tol "
        f"{x_tol:.3g}), |df|={df:.3g} (tol {f_tol:.3g})")
    check(np.all(np.isfinite(x32)), "single: non-finite f32 solution")
    check(dx <= x_tol, f"single: f32 x off f64 by {dx}")
    check(df <= f_tol, f"single: f32 f off f64 by {df}")
    results["single"] = {"seconds": t, "dx": dx, "df": df}


# ------------------------------------------------------------ phase 3

def _hs65_batch(B):
    import numpy as np

    import enlsip_tpu as et
    from enlsip_tpu.core.driver import Functions
    from enlsip_tpu.core.types import Dims
    from enlsip_tpu.models.model import _model_functions
    from problems import HS65
    import jax.numpy as jnp

    model = et.CnlsModel(**HS65)
    res_fn, jac_res, cons, jac_cons = _model_functions(model, jnp.float32)
    fns = Functions(res=res_fn, jac_res=jac_res, cons=cons,
                    jac_cons=jac_cons)
    rng = np.random.default_rng(SEED)
    starts = np.asarray(HS65["starting_point"])[None, :] + \
        0.3 * rng.normal(size=(B, 3))
    return fns, Dims(n=3, m=3, q=0, l=7), starts


def phase_batched(results):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from enlsip_tpu.core.types import Options
    from enlsip_tpu.parallel import solve_batched
    from problems import HS65_FSTAR

    fns, dims, starts = _hs65_batch(HS65_LANES)
    tols = _tols(jnp.float32)

    def run():
        res = solve_batched(fns, starts, dims, Options(), tols,
                            dtype=jnp.float32)
        jax.block_until_ready(res.f)
        return res

    out = {}
    for label, ctx in (("kernel", contextlib.nullcontext()),
                       ("xla", plain_xla())):
        with ctx:
            res = run()
            t = median_seconds(run)
        f, ec = np.asarray(res.f), np.asarray(res.exit_code)
        out[label] = (f, ec, t)
        say(f"batched: HS65 B={HS65_LANES} [{label} CPQR] "
            f"{t:.4f} s/solve-batch (median of {TIMING_REPS}), "
            f"{HS65_LANES / t:.1f} solves/s, match rate "
            f"{match_rate(f, HS65_FSTAR).mean():.4f}")
        check(np.all(np.isfinite(f)), f"batched: non-finite f ({label})")
    (fk, ek, tk), (fx, ex, tx) = out["kernel"], out["xla"]
    mk, mx = match_rate(fk, HS65_FSTAR).mean(), match_rate(fx, HS65_FSTAR).mean()
    both = (ek > 0) & (ex > 0)
    df = float(np.max(np.abs(fk - fx)[both])) if both.any() else 0.0
    # Lanes converged in both runs sit at the same optimum up to f32
    # noise; 1e-3 relative is the match rule's own width.
    f_tol = 1e-3 * max(1.0, HS65_FSTAR)
    say(f"batched: match rate kernel {mk:.4f} vs xla {mx:.4f} (|diff| "
        f"tol 0.005); {int(both.sum())} lanes converged in both, max|df| "
        f"{df:.3g} (tol {f_tol:.3g}); exit codes equal on "
        f"{int((ek == ex).sum())}/{HS65_LANES}; end-to-end kernel/xla "
        f"time ratio {tk / tx:.3f}")
    check(abs(mk - mx) <= 0.005, "batched: match rates differ")
    check(mk >= 0.9, f"batched: match rate {mk}")
    check(df <= f_tol, f"batched: f differs by {df} on converged lanes")
    results["batched"] = {"kernel_s": tk, "xla_s": tx, "match": mk}


# ------------------------------------------------------------ phase 4

def _fused_solve(per_family, mesh=None):
    import jax
    import jax.numpy as jnp

    from enlsip_tpu.core.types import Options
    from enlsip_tpu.parallel.hetero import fuse_families, solve_suite_fused
    from enlsip_tpu.parallel.suite import hs_scenario_batch

    fams = hs_scenario_batch(list(FUSED_FAMILIES), per_family=per_family,
                             seed=SEED)
    fused = fuse_families(fams)
    opts = Options(max_iter=60, second_derivatives=False)

    def run():
        out = solve_suite_fused(fams, opts, _tols, mesh=mesh,
                                dtype=jnp.float32, fused=fused)
        jax.block_until_ready(out)
        return out

    return fams, run


def _fused_summary(fams, out):
    import numpy as np
    f = np.concatenate([np.asarray(out[k].f) for k in fams])
    ec = np.concatenate([np.asarray(out[k].exit_code) for k in fams])
    matched = np.concatenate([match_rate(out[k].f, fams[k].fstar)
                              for k in fams])
    return f, ec, matched


def phase_fused(results):
    import jax
    import numpy as np

    fams, run = _fused_solve(FUSED_PER_FAMILY)
    B = FUSED_PER_FAMILY * len(FUSED_FAMILIES)
    out = {}
    for label, ctx in (("kernel", contextlib.nullcontext()),
                       ("xla", plain_xla())):
        with ctx:
            res = run()
            t = median_seconds(run)
            peak = peak_bytes(jax.devices()[0])
        f, ec, matched = _fused_summary(fams, res)
        out[label] = (f, ec, matched.mean(), t)
        say(f"fused: {len(FUSED_FAMILIES)} HS families, {B} lanes "
            f"[{label} CPQR] {t:.4f} s (median of {TIMING_REPS}), "
            f"{B / t:.1f} solves/s, match rate {matched.mean():.4f}, "
            f"peak_bytes_in_use {peak / 2**30:.3f} GiB")
        check(np.all(np.isfinite(f)), f"fused: non-finite f ({label})")
    (fk, ek, mk, tk), (fx, ex, mx, tx) = out["kernel"], out["xla"]
    check(abs(mk - mx) <= 0.005, f"fused: match rates {mk} vs {mx}")
    check(mk >= 0.9, f"fused: match rate {mk}")
    say(f"fused: end-to-end kernel/xla time ratio {tk / tx:.3f}")
    results["fused"] = {"kernel_s": tk, "xla_s": tx, "match": mk,
                        "peak_gib": peak / 2**30}


# ------------------------------------------------------------ phase 5

def giant_data(key_seed=SEED):
    """The giant-m fit's data, generated on the device from a seed."""
    import jax
    import jax.numpy as jnp
    k1, k2, k3 = jax.random.split(jax.random.key(key_seed), 3)
    W = jax.random.normal(k1, (GIANT_M, GIANT_N), jnp.float32) / \
        jnp.sqrt(jnp.float32(GIANT_N))
    xtrue = jax.random.normal(k2, (GIANT_N,), jnp.float32)
    z = W @ xtrue
    Y = z + 0.1 * jnp.tanh(z) + 0.01 * jax.random.normal(
        k3, (GIANT_M,), jnp.float32)
    # x_j >= xtrue_j + 0.2 for the first 5 parameters cuts off the
    # unconstrained optimum: the solve ends with 5 active constraints.
    return {"W": W, "Y": Y, "blo": xtrue[:GIANT_T] + 0.2}


def giant_functions(factored: bool = True):
    """Problem callables taking the data pytree as their last argument
    (the giant arrays enter the jitted solve as arguments).  With
    ``factored`` the Jacobian is given as diag(rowscale) @ W and is
    never materialized."""
    import jax
    import jax.numpy as jnp

    from enlsip_tpu.core.driver import Functions

    def cons(x, d):
        return jnp.concatenate([
            x[:GIANT_T] - d["blo"], x[GIANT_T:GIANT_L - 1] + 5.0,
            jnp.array([GIANT_N * 4.0 - jnp.dot(x, x)], x.dtype)])

    def res(x, d):
        z = d["W"] @ x
        return d["Y"] - (z + 0.1 * jnp.tanh(z))

    def jac(x, d):
        z = d["W"] @ x
        return -(1.0 + 0.1 * (1.0 - jnp.tanh(z) ** 2))[:, None] * d["W"]

    def res_trial(x, p, d):
        zxp = d["W"] @ jnp.stack([x, p], axis=1)
        zx, zp = zxp[:, 0], zxp[:, 1]

        def at(a):
            u = zx + a.astype(zx.dtype) * zp
            return d["Y"] - (u + 0.1 * jnp.tanh(u))
        return at

    def rowscale(x, d):
        z = d["W"] @ x
        return -(1.0 + 0.1 * (1.0 - jnp.tanh(z) ** 2))

    fns = Functions(res=res, jac_res=jac, cons=cons,
                    jac_cons=lambda x, d: jax.jacfwd(cons)(x, d),
                    res_trial=res_trial)
    if factored:
        fns = fns._replace(jac_rowscale=rowscale, jac_base=lambda d: d["W"])
    return fns


def giant_solve_one_card(data, factored: bool = True):
    """The giant-m fit on one card: init_carry + run_chunk in one jit,
    matmul precision scoped as ``solve`` does."""
    import jax
    import jax.numpy as jnp

    from enlsip_tpu.core.driver import init_carry, run_chunk
    from enlsip_tpu.core.types import Dims, Options, matmul_precision_scope
    from enlsip_tpu.parallel.rowsharded import _bind_rows

    dims = Dims(n=GIANT_N, m=GIANT_M, q=0, l=GIANT_L)
    opts = Options(second_derivatives=False, max_iter=GIANT_ITERS)
    fns = giant_functions(factored)
    tols = _tols(jnp.float32)

    @jax.jit
    def solve(data, tols):
        f = _bind_rows(fns, data)
        c = init_carry(f, jnp.zeros(GIANT_N, jnp.float32), dims, opts,
                       jnp.float32)
        c = run_chunk(c, f, dims, opts, tols, opts.max_iter + 1)
        return c.x, c.nb_iter, c.exit_code, c.active_mask

    def run():
        with matmul_precision_scope(opts):
            out = solve(data, tols)
        jax.block_until_ready(out)
        return out

    return run


def phase_giant(results):
    import numpy as np

    data = giant_data()
    out = {}
    for label, factored in (("factored J", True), ("dense J", False)):
        run = giant_solve_one_card(data, factored)
        x, it, ec, act = run()
        t = median_seconds(run)
        x, it, ec, act = (np.asarray(x), int(it), int(ec),
                          np.asarray(act))
        out[label] = (x, ec, act, t)
        say(f"giant: {GIANT_M}x{GIANT_N}, l={GIANT_L}, {label}: {t:.4f} s "
            f"for {it} iterations (median of {TIMING_REPS}), "
            f"{it / t:.2f} it/s, exit {ec}, active {int(act.sum())}")
        check(ec > 0, f"giant: exit code {ec} ({label})")
        check(int(act.sum()) == GIANT_T,
              f"giant: {int(act.sum())} active constraints ({label})")
    (xf, ef, af, tf), (xd, ed, ad, td) = out["factored J"], out["dense J"]
    dx = float(np.max(np.abs(xf - xd)))
    # Both runs are f32 and differ only in where the row scale enters
    # the WY apply; 8 GN steps on this well-conditioned fit keep x
    # within 1e-4 relative.
    x_tol = 1e-4 * max(1.0, float(np.max(np.abs(xd))))
    say(f"giant: factored vs dense max|dx| {dx:.3g} (tol {x_tol:.3g}), "
        f"exit {ef} vs {ed}, same active set {bool((af == ad).all())}")
    check(dx <= x_tol, f"giant: x differs by {dx}")
    check((af == ad).all(), "giant: active sets differ")
    results["giant"] = {"factored_s": tf, "dense_s": td, "exit": ef}


# ------------------------------------------------------------ phase 6

def _cpqr_inputs(rows, cols, B=CPQR_LANES):
    import jax
    import jax.numpy as jnp
    return jax.random.normal(jax.random.key(rows * 100 + cols),
                             (B, rows, cols), jnp.float32)


def _cpqr_xla_batched(M):
    import jax

    from enlsip_tpu.ops.blocked_qr import NB, _cpqr_xla
    return jax.vmap(lambda m: _cpqr_xla(m, NB, None))(M)


def phase_kernels(results):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from enlsip_tpu.ops import pallas_batched_qr as pbq

    # ---- batched CPQR: kernel vs the vmapped XLA loop -----------------
    # (under the float32 matmul scope every solve installs: the compact
    # WY T factors are built by XLA matmuls around the kernel)
    for rows, cols in CPQR_SHAPES:
        M = _cpqr_inputs(rows, cols)
        with jax.default_matmul_precision("float32"):
            fk = jax.jit(pbq.cpqr_blocked_batched)(M)
            fx = jax.jit(_cpqr_xla_batched)(M)
        col_scale = float(jnp.max(jnp.linalg.norm(M, axis=1)))
        tol = 5e-5 * col_scale
        same_perm = bool(np.array_equal(np.asarray(fk.perm),
                                        np.asarray(fx.perm)))
        errs = {n: float(jnp.max(jnp.abs(getattr(fk, n) - getattr(fx, n))))
                for n in ("R", "V", "tau", "T")}
        say(f"kernels: batched CPQR B={CPQR_LANES} {rows}x{cols} "
            f"(lane block {pbq.lane_block(rows, cols, CPQR_LANES)}): perm "
            f"identical {same_perm}; max|err| " +
            ", ".join(f"{n} {e:.3g}" for n, e in errs.items()) +
            f" (tol 5e-5 x column scale = {tol:.3g})")
        check(same_perm, f"kernels: CPQR perm differs at {rows}x{cols}")
        for n, e in errs.items():
            check(e <= tol, f"kernels: CPQR {n} err {e} at {rows}x{cols}")

    # ---- precision probe: IEEE f32 arithmetic, not TF32 --------------
    # Column 1 is column 0 times 1 + 2^-14, a bit below TF32's 10-bit
    # mantissa: IEEE f32 norms pivot column 1 first, TF32 ones would
    # see a tie and keep column 0.
    Mp = jnp.ones((CPQR_LANES, 4, 2), jnp.float32)
    Mp = Mp.at[:, :, 1].multiply(1.0 + 2.0 ** -14)
    first = {}
    with jax.default_matmul_precision("float32"):
        for label, fn in (("kernel", pbq.cpqr_blocked_batched),
                          ("xla", _cpqr_xla_batched)):
            first[label] = np.asarray(jax.jit(fn)(Mp).perm)[:, 0]
    say(f"kernels: IEEE probe, lanes pivoting the 1+2^-14 column first: "
        f"kernel {int((first['kernel'] == 1).sum())}, xla "
        f"{int((first['xla'] == 1).sum())} of {CPQR_LANES}")
    check(bool(np.all(first["kernel"] == 1)),
          "kernels: CPQR norms are not IEEE f32")
    results["kernels"] = {"ieee_probe": True}


# ------------------------------------------------------------ phase 7

def _looped(fn, perturb, iters=LOOP_ITERS):
    """``iters`` dependent calls of ``fn`` inside one jit: each call's
    input depends on the previous output through ``perturb(args, acc)``
    so XLA cannot hoist or merge them."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(*args):
        def body(_, acc):
            out = fn(*perturb(args, acc))
            leaf = jax.tree.leaves(out)[-1]
            return acc + jnp.ravel(leaf)[0].astype(acc.dtype)
        return jax.lax.fori_loop(0, iters, body, jnp.zeros((), jnp.float32))
    return run


def phase_timing(results):
    import jax

    from enlsip_tpu.ops import pallas_batched_qr as pbq

    rows_out = {}
    for rows, cols in CPQR_SHAPES:
        M = _cpqr_inputs(rows, cols)
        pert = lambda a, acc: (a[0] + acc * 0.0,)
        per = {}
        for label, fn in (("kernel", pbq.cpqr_blocked_batched),
                          ("xla", _cpqr_xla_batched)):
            run = _looped(fn, pert)
            with jax.default_matmul_precision("float32"):
                per[label] = median_seconds(
                    lambda: jax.block_until_ready(run(M))) / LOOP_ITERS
        rows_out[f"cpqr_{rows}x{cols}"] = per
        say(f"timing: batched CPQR B={CPQR_LANES} {rows}x{cols}: kernel "
            f"{per['kernel'] * 1e6:.1f} us, xla {per['xla'] * 1e6:.1f} us "
            f"per call (median of {TIMING_REPS} x {LOOP_ITERS} in one jit)")
    results["timing"] = rows_out


# ---------------------------------------------------------- four cards

def phase_four_fused(results):
    import jax
    import numpy as np

    from enlsip_tpu.parallel.sharding import batch_mesh

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    per_family = FOUR_PER_CARD * 4 // len(FUSED_FAMILIES)
    B = per_family * len(FUSED_FAMILIES)
    mesh = batch_mesh()
    fams, run4 = _fused_solve(per_family, mesh=mesh)
    out4 = run4()
    t4 = median_seconds(run4)
    shard_devs = {d for k in fams for d in out4[k].x.sharding.device_set}
    peaks = [peak_bytes(d) for d in devs]
    f4, e4, m4 = _fused_summary(fams, out4)
    say(f"four/fused: {B} lanes over batch_mesh() on {len(devs)} cards "
        f"{t4:.4f} s (median of {TIMING_REPS}), {B / t4:.1f} solves/s, "
        f"match rate {m4.mean():.4f}; result shards on "
        f"{len(shard_devs)} devices; peak_bytes_in_use per card (GiB) "
        + ", ".join(f"{p / 2**30:.3f}" for p in peaks))
    check(len(shard_devs) == 4, "four/fused: results not on all 4 cards")
    check(min(peaks) > 0.5 * max(peaks), "four/fused: uneven card use")
    del out4
    _, run1 = _fused_solve(per_family, mesh=None)
    out1 = run1()
    t1 = median_seconds(run1)
    f1, e1, m1 = _fused_summary(fams, out1)
    both = (e4 > 0) & (e1 > 0)
    df = np.abs(f4 - f1)[both]
    f_tol = 1e-3 * np.maximum(1.0, np.abs(f1[both]))
    say(f"four/fused: same {B} lanes on one card {t1:.4f} s, match rate "
        f"{m1.mean():.4f} (|diff| tol 0.001); {int(both.sum())} lanes "
        f"converged in both, {int((df > f_tol).sum())} with |df| above "
        f"1e-3 max(1,|f|); 4-card speed-up {t1 / t4:.3f}")
    check(abs(m4.mean() - m1.mean()) <= 0.001, "four/fused: match rates")
    check(bool(np.all(df <= f_tol)), "four/fused: f differs")
    results["four_fused"] = {"t4": t4, "t1": t1, "match4": m4.mean()}


def phase_four_rows(results):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from enlsip_tpu.core.types import Dims, Options
    from enlsip_tpu.parallel.rowsharded import row_mesh, solve_rowsharded

    devs = jax.devices()
    dims = Dims(n=GIANT_N, m=GIANT_M, q=0, l=GIANT_L)
    opts = Options(second_derivatives=False, max_iter=GIANT_ITERS)
    tols = _tols(jnp.float32)
    fns = giant_functions()
    data = giant_data()
    x0 = jnp.zeros(GIANT_N, jnp.float32)
    runs = {}
    for label, ds, tsqr in (("1 card", devs[:1], False),
                            ("4 cards", devs, False),
                            ("4 cards tsqr", devs, True)):
        mesh = row_mesh(ds)

        def run():
            c = solve_rowsharded(fns, x0, dims, opts, tols, mesh=mesh,
                                 tsqr=tsqr, data=data)
            jax.block_until_ready(c.x)
            return c

        c = run()
        t = median_seconds(run)
        placed = len(c.rx.sharding.device_set)
        runs[label] = (np.asarray(c.x), int(c.exit_code),
                       np.asarray(c.active_mask), t)
        say(f"four/rows: giant-m {GIANT_M}x{GIANT_N} solve_rowsharded "
            f"[{label}] {t:.4f} s (median of {TIMING_REPS}), "
            f"{int(c.nb_iter)} iterations, exit {int(c.exit_code)}, "
            f"active {int(np.asarray(c.active_mask).sum())}, rows on "
            f"{placed} devices")
        check(placed == len(ds), f"four/rows: rows on {placed} devices")
        check(int(c.exit_code) > 0, f"four/rows: exit {int(c.exit_code)}")
    x1, e1, a1, t1 = runs["1 card"]
    for label in ("4 cards", "4 cards tsqr"):
        x, e, a, t = runs[label]
        dx = float(np.max(np.abs(x - x1)))
        x_tol = 1e-4 * max(1.0, float(np.max(np.abs(x1))))
        say(f"four/rows: [{label}] vs 1 card max|dx| {dx:.3g} (tol "
            f"{x_tol:.3g}), exit class {e} vs {e1}, same active set "
            f"{bool((a == a1).all())}; speed-up {t1 / t:.3f}")
        check(dx <= x_tol, f"four/rows: x differs ({label})")
        check(e == e1, f"four/rows: exit {e} vs {e1} ({label})")
        check(bool((a == a1).all()), f"four/rows: active set ({label})")
    results["four_rows"] = {k: v[3] for k, v in runs.items()}


# ---------------------------------------------------------------- main

PHASES = {"device": phase_device, "single": phase_single,
          "batched": phase_batched, "fused": phase_fused,
          "giant": phase_giant, "kernels": phase_kernels,
          "timing": phase_timing}
FOUR = {"device": phase_device, "four_fused": phase_four_fused,
        "four_rows": phase_four_rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths and their "
                         "one-card comparisons")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "enlsip_tpu")):
        print("chip_smoke: the enlsip_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from enlsip_tpu.utils import enable_compile_cache
    enable_compile_cache()

    table = FOUR if args.four else PHASES
    results = {}
    for name in table:
        t0 = time.perf_counter()
        print(f"--- phase {name}", flush=True)
        try:
            table[name](results)
        except Exception as e:  # report which phase failed, then fail
            print(f"chip_smoke: phase {name} FAILED: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
            if not isinstance(e, SmokeFailure):
                raise
            return 1
        print(f"--- phase {name} done in {time.perf_counter() - t0:.1f} s "
              f"(compile included)", flush=True)
    print(json.dumps({"ok": True, "device": results["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
