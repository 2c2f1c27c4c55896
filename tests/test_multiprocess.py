"""Multi-process jax.distributed path: the CPU harness executes the
REAL multi-host code (jax.distributed.initialize + gloo collectives +
make_array_from_process_local_data -> solve_batched_sharded_mp) with 2
processes x 2 virtual devices and asserts per-lane parity against the
unsharded local solve.

This is the executable evidence for SURVEY §2.4/§5.8's multi-host
scenario batching (no reference counterpart: Enlsip.jl is
single-process, enlsip_functions.jl:2776-2878).  The full-size scaling
measurement lives in benchmarks/multiproc_harness.py / bench.py; this
test runs the same harness at CI sizes.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(REPO, "benchmarks", "multiproc_harness.py")


def test_multiprocess_parity_and_scaling_proxy():
    out = subprocess.run(
        [sys.executable, HARNESS, "--quick"],
        capture_output=True, text=True, timeout=850, cwd=REPO)
    result = None
    for line in out.stdout.splitlines():
        if line.startswith("MULTIPROC_RESULT "):
            result = json.loads(line[len("MULTIPROC_RESULT "):])
    assert result is not None, (out.stdout[-3000:], out.stderr[-2000:])
    assert result["parity_ok"], result

    for run_key, nproc, ndev in (("run_1proc", 1, 2), ("run_2proc", 2, 4)):
        run = result[run_key]
        assert run["procs_ok"], run
        assert len(run["workers"]) == nproc
        for w in run["workers"]:
            assert w["n_devices_global"] == ndev
            assert w["hs65"]["ok"], w
            assert w["hs65"]["codes_equal"] == w["hs65"]["lanes"]
            # Local lanes have been bit-exact in every observed run;
            # allow float-noise headroom against XLA layout changes.
            assert w["hs65"]["max_x_err"] <= 1e-12
            assert w["suite"]["ok"], w

    assert result["weak_scaling_efficiency"] is not None
    # Floor teeth: at the quick size (b_local=8) the
    # proxy is sync-dominated (CPU processes, measured ~0.34).  The
    # loose floor is a regression tripwire for the distributed path
    # (e.g. a stray per-step host sync would crater it), not the
    # BASELINE >=90% evidence — that is the bench-size measurement.
    assert result["weak_scaling_efficiency"] >= 0.15, result
    # The sharded-vs-local overhead share must also be recorded.
    assert 0.0 <= result["collective_fraction"] <= 1.0, result
