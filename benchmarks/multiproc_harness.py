"""Multi-process (multi-host proxy) harness for the sharded batch path.

BASELINE's "multi-host scenario batching" axis targets >=90% scaling
efficiency to 2+ hosts.  Multi-host hardware is not available to CI,
so this harness executes the REAL multi-process code path —
``jax.distributed.initialize`` + ``jax.make_array_from_process_local_data``
feeding :func:`enlsip_tpu.parallel.sharding.solve_batched_sharded_mp` —
on N local CPU processes (each with its own virtual devices, collectives
over gloo).  This catches the process-local-shape and
addressable-devices bug classes a single-process virtual mesh cannot,
and records a weak-scaling proxy (fixed per-process batch, 1 vs 2
processes) for the BASELINE metric.

No reference counterpart: Enlsip.jl is single-process
(/root/reference/src/enlsip_functions.jl — one sequential while loop).

Usage:
  python benchmarks/multiproc_harness.py               # full bench run
  python benchmarks/multiproc_harness.py --quick       # CI/test sizes
  (worker mode is internal: spawned by the parent.)

Output: one JSON line prefixed MULTIPROC_RESULT on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------
# Worker
# --------------------------------------------------------------------

def worker(args) -> None:
    # Env (JAX_PLATFORMS=cpu, XLA_FLAGS device count) was set by the
    # parent before this interpreter started.
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # CPU executable (de)serialization through the persistent cache
    # segfaults nondeterministically in this jaxlib (see tests/conftest).
    jax.config.update("jax_enable_compilation_cache", False)
    jax.distributed.initialize(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.nproc, process_id=args.pid)

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from enlsip_tpu.core.types import Options, Tols
    from enlsip_tpu.parallel.batch import solve_batched
    from enlsip_tpu.parallel.hetero import fuse_families
    from enlsip_tpu.parallel.sharding import (batch_mesh, local_lanes,
                                              solve_batched_sharded_mp)
    from enlsip_tpu.parallel.suite import hs_scenario_batch

    assert jax.process_count() == args.nproc
    assert len(jax.local_devices()) == args.dev_per_proc
    mesh = batch_mesh()
    pid, nproc = args.pid, args.nproc
    opts = Options()
    dtype = jnp.float64

    def tols(dt):
        eps = float(jnp.finfo(dt).eps)
        rel = float(np.sqrt(eps))
        return Tols(*(jnp.asarray(v, dt) for v in (1e-10, rel, rel, rel,
                                                   rel)))

    report = {"pid": pid, "nproc": nproc,
              "n_devices_global": len(jax.devices())}

    def lane_slice(a):
        return np.asarray(a)[pid * args.b_local:(pid + 1) * args.b_local]

    def parity(res, fns, dims, x0_local, data_local=None, rdims_local=None):
        """Local lanes of the global result vs an unsharded local solve."""
        got = {k: local_lanes(getattr(res, k))
               for k in ("exit_code", "x", "f", "n_iter")}
        ref = solve_batched(fns, x0_local, dims, opts, tols(dtype),
                            dtype=dtype, data=data_local, rdims=rdims_local)
        code_eq = int(np.sum(got["exit_code"] == np.asarray(ref.exit_code)))
        x_err = float(np.max(np.abs(got["x"] - np.asarray(ref.x))))
        f_err = float(np.max(np.abs(got["f"] - np.asarray(ref.f))))
        return {"lanes": int(args.b_local), "codes_equal": code_eq,
                "max_x_err": x_err, "max_f_err": f_err,
                "ok": bool(code_eq == args.b_local and x_err < 1e-8)}

    # ---- scenario 1: homogeneous sharded batch (HS65) ----------------
    fams = hs_scenario_batch(["hs65"], per_family=nproc * args.b_local,
                             seed=0)
    spec = fams["hs65"]
    x0_local = lane_slice(spec.x0_batch)
    res = solve_batched_sharded_mp(spec.fns, x0_local, spec.dims, opts,
                                   tols(dtype), mesh=mesh, dtype=dtype,
                                   check_every=args.check_every)
    jax.block_until_ready(res.exit_code)
    report["hs65"] = parity(res, spec.fns, spec.dims, x0_local)

    # Weak-scaling timing: re-run the (compiled) sharded solve.
    multihost_utils.sync_global_devices("t0")
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        r = solve_batched_sharded_mp(spec.fns, x0_local, spec.dims, opts,
                                     tols(dtype), mesh=mesh, dtype=dtype,
                                     check_every=args.check_every)
        jax.block_until_ready(r.exit_code)
        multihost_utils.sync_global_devices("rep")
        times.append(time.perf_counter() - t0)
    report["hs65"]["t_solve_s"] = float(np.median(times))
    report["hs65"]["check_every"] = args.check_every

    # Local-only reference timing (same lanes, no sharded assembly, no
    # cross-process collectives; compiled above inside parity()): the
    # sharded-minus-local gap is the per-step price of the distributed
    # path — collectives + sharded-array assembly + lockstep sync.
    times_loc = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        rloc = solve_batched(spec.fns, x0_local, spec.dims, opts,
                             tols(dtype), dtype=dtype)
        jax.block_until_ready(rloc.exit_code)
        times_loc.append(time.perf_counter() - t0)
    report["hs65"]["t_local_s"] = float(np.median(times_loc))

    # ---- scenario 2: fused heterogeneous suite ------------------------
    if args.suite:
        names = ["hs14", "hs65", "hs26", "hs53"]
        per_family = max(args.dev_per_proc * nproc,
                         (args.b_local // 2 // len(names) or 1)
                         * args.dev_per_proc * nproc)
        sfams = hs_scenario_batch(names, per_family=per_family, seed=1)
        fused = fuse_families(sfams)  # deterministic: same on every proc
        B = fused.x0.shape[0]
        assert B % nproc == 0 and (B // nproc) % args.dev_per_proc == 0, B
        b_loc = B // nproc

        def fused_slice(a):
            return np.asarray(a)[pid * b_loc:(pid + 1) * b_loc]

        x0_l = fused_slice(fused.x0)
        data_l = jax.tree.map(fused_slice, fused.data)
        rdims_l = jax.tree.map(fused_slice, fused.rdims)
        resf = solve_batched_sharded_mp(
            fused.fns, x0_l, fused.dims, opts, tols(dtype), mesh=mesh,
            dtype=dtype, data_local=data_l, rdims_local=rdims_l)
        jax.block_until_ready(resf.exit_code)
        got = {k: local_lanes(getattr(resf, k))
               for k in ("exit_code", "x", "f")}
        ref = solve_batched(fused.fns, x0_l, fused.dims, opts, tols(dtype),
                            dtype=dtype, data=data_l, rdims=rdims_l)
        # Sharded buffers partition differently than the local-ref run,
        # so individual float ops may round differently (<= 1 ulp);
        # exit-code bits can flip on rare knife-edge lanes (same class
        # as tests/test_hetero.py's fused-vs-bucketed comparison).
        # Require: >= 99.9% identical codes, and x parity on the
        # code-matching lanes.
        same = got["exit_code"] == np.asarray(ref.exit_code)
        code_eq = int(np.sum(same))
        x_err = float(np.max(np.abs(
            got["x"][same] - np.asarray(ref.x)[same])))
        report["suite"] = {
            "lanes": int(b_loc), "codes_equal": code_eq,
            "max_x_err_matched": x_err,
            "ok": bool(code_eq >= 0.999 * b_loc and x_err < 1e-6)}

    print("WORKER_RESULT " + json.dumps(report), flush=True)
    jax.distributed.shutdown()


# --------------------------------------------------------------------
# Parent
# --------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_config(nproc: int, b_local: int, dev_per_proc: int, repeats: int,
               suite: bool, timeout_s: float, check_every: int = 4,
               cores_pp: int | None = None) -> dict:
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dev_per_proc}")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd_base = [sys.executable, os.path.abspath(__file__), "--worker",
                "--nproc", str(nproc), "--port", str(port),
                "--b-local", str(b_local), "--dev-per-proc",
                str(dev_per_proc), "--repeats", str(repeats),
                "--check-every", str(check_every)]
    if suite:
        cmd_base.append("--suite")

    # Pin each process to DISJOINT cores so per-process hardware is
    # constant across the 1-proc/2-proc comparison (a weak-scaling proxy
    # on one machine is meaningless if N processes contend for the same
    # cores — each "host" must get its own).  Falls back gracefully when
    # taskset or enough cores are unavailable.
    ncores = os.cpu_count() or 1
    if cores_pp is None:
        cores_pp = max(1, ncores // max(nproc, 2))
    have_taskset = subprocess.run(["which", "taskset"],
                                  capture_output=True).returncode == 0

    def pinned(pid, cmd):
        if not have_taskset or cores_pp * nproc > ncores:
            return cmd
        lo, hi = pid * cores_pp, (pid + 1) * cores_pp - 1
        return ["taskset", "-c", f"{lo}-{hi}"] + cmd

    procs = [subprocess.Popen(pinned(pid, cmd_base + ["--pid", str(pid)]),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for pid in range(nproc)]
    outs, ok = [], True
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            ok = False
        outs.append(out)
        ok = ok and p.returncode == 0
    reports = []
    for out in outs:
        rep = None
        for line in out.splitlines():
            if line.startswith("WORKER_RESULT "):
                rep = json.loads(line[len("WORKER_RESULT "):])
        if rep is None:
            ok = False
        reports.append(rep)
    result = {"nproc": nproc, "b_local": b_local,
              "dev_per_proc": dev_per_proc, "cores_pp": cores_pp,
              "procs_ok": ok, "workers": reports}
    if not ok:
        result["logs_tail"] = [o[-2000:] for o in outs]
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--b-local", dest="b_local", type=int, default=4096)
    ap.add_argument("--dev-per-proc", dest="dev_per_proc", type=int,
                    default=2)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--check-every", dest="check_every", type=int, default=8)
    ap.add_argument("--suite", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()

    if args.worker:
        worker(args)
        return

    if args.quick:
        b_local, repeats, suite = 8, 1, True
    else:
        b_local, repeats, suite = args.b_local, args.repeats, True

    summary = {"b_local": b_local, "dev_per_proc": args.dev_per_proc,
               "check_every": args.check_every}
    # Interleave 1-proc/2-proc runs and take per-config minima: the
    # shared-machine proxy is noisy (CPU frequency drift, other load),
    # and min-of-runs is the standard estimator for it.
    # ENLSIP_MP_ROUNDS=1 (bench.py sets it) halves the 1/2-proc chain:
    # min-of-2-rounds is the noise-robust standalone default, but the
    # bench's end-to-end budget matters more than the last few percent
    # of proxy stability.
    rounds = 1 if args.quick else int(os.environ.get("ENLSIP_MP_ROUNDS",
                                                     "2"))
    ones, twos = [], []
    for _ in range(rounds):
        ones.append(run_config(1, b_local, args.dev_per_proc, repeats,
                               suite, args.timeout, args.check_every))
        twos.append(run_config(2, b_local, args.dev_per_proc, repeats,
                               suite, args.timeout, args.check_every))
    summary["run_1proc"] = ones[-1]
    summary["run_2proc"] = twos[-1]
    parity_ok = all(
        r["procs_ok"] and all(
            w and w["hs65"]["ok"] and w.get("suite", {"ok": True})["ok"]
            for w in r["workers"])
        for r in ones + twos)
    summary["parity_ok"] = parity_ok
    if parity_ok:
        t1 = min(r["workers"][0]["hs65"]["t_solve_s"] for r in ones)
        t2 = min(max(w["hs65"]["t_solve_s"] for w in r["workers"])
                 for r in twos)
        # Weak scaling at fixed per-process batch: ideal t2 == t1.
        summary["t_1proc_s"] = t1
        summary["t_2proc_s"] = t2
        summary["weak_scaling_efficiency"] = t1 / t2 if t2 > 0 else None
        # Distributed-path overhead share (collectives + sharded-array
        # assembly + lockstep sync): sharded-vs-local gap on the SAME
        # process/lanes/hardware.  An upper bound on the pure
        # collective share.
        w2 = max(twos[-1]["workers"], key=lambda w: w["hs65"]["t_solve_s"])
        if w2["hs65"].get("t_local_s"):
            summary["collective_fraction"] = max(
                0.0, 1.0 - w2["hs65"]["t_local_s"] / w2["hs65"]["t_solve_s"])

    # 4-process chain.  Needs its OWN 1-core-per-process
    # baseline: this machine has few cores, and a weak-scaling ratio is
    # only meaningful when per-process hardware is constant across the
    # compared configs.
    ncores = os.cpu_count() or 1
    if not args.quick and ncores >= 4:
        one1 = run_config(1, b_local, args.dev_per_proc, repeats, False,
                          args.timeout, args.check_every, cores_pp=1)
        four = run_config(4, b_local, args.dev_per_proc, repeats, False,
                          args.timeout, args.check_every, cores_pp=1)
        summary["run_4proc"] = four
        ok4 = (one1["procs_ok"] and four["procs_ok"]
               and all(w and w["hs65"]["ok"] for w in four["workers"]))
        summary["parity_ok_4proc"] = ok4
        if ok4:
            t1c = one1["workers"][0]["hs65"]["t_solve_s"]
            t4 = max(w["hs65"]["t_solve_s"] for w in four["workers"])
            summary["t_1proc_1core_s"] = t1c
            summary["t_4proc_s"] = t4
            summary["weak_scaling_efficiency_4proc"] = (t1c / t4
                                                        if t4 > 0 else None)
    print("MULTIPROC_RESULT " + json.dumps(summary), flush=True)
    sys.exit(0 if parity_ok else 1)


if __name__ == "__main__":
    main()
