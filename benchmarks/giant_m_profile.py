"""Op-level profile of the giant-m (5M x 100) GN iteration: trace one
full solve on the GPU and aggregate device-op durations from the Chrome
trace.

Usage: python benchmarks/giant_m_profile.py [max_iter]
Prints a per-op table (total ms, share) + per-iteration numbers; the
trace is kept under <repo>/chiprun_out/giant_m_trace.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from collections import defaultdict

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo)


def parse_trace(trace_dir: str) -> dict:
    """Aggregate device-lane LEAF op durations (while/conditional parent
    events span their bodies and would double-count) by op name, with
    per-op source line, bytes_accessed, and model_flops from the newest
    jax.profiler Chrome trace under ``trace_dir``."""
    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins/profile/*/*.trace.json.gz")))
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    with gzip.open(files[-1], "rt") as fh:
        data = json.load(fh)
    events = data.get("traceEvents", [])
    pid_names = {e["pid"]: e["args"].get("name", "")
                 for e in events
                 if e.get("ph") == "M" and e.get("name") == "process_name"
                 and "args" in e}
    # GPU device planes are named "/device:GPU:<i>" (host threads are
    # "/host:...").
    device_pids = {pid for pid, name in pid_names.items()
                   if "/device:GPU" in name}
    tot = defaultdict(float)
    cnt = defaultdict(int)
    meta = {}
    parents = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        name = e.get("name", "?")
        args = e.get("args") or {}
        cat = args.get("hlo_category", "")
        if cat in ("while", "conditional") or name.startswith("jit_"):
            parents[name] += e.get("dur", 0.0)
            continue
        tot[name] += e.get("dur", 0.0)  # us
        cnt[name] += 1
        if name not in meta:
            src = args.get("source", "")
            scope = ""
            long = args.get("long_name", "")
            # named_scope prefixes show up in the HLO metadata op path
            for s in ("wrkset", "analys", "stplng", "new_point",
                      "factor_stage1", "ws_round1", "ws_round2"):
                if f"{s}/" in long or f'"{s}' in long:
                    scope = s
                    break
            meta[name] = {
                "source": src.replace(_repo + "/", ""),
                "scope": scope,
                "gb": float(args.get("bytes_accessed", 0)) / 2**30,
                "gflops": float(args.get("model_flops", 0)) / 1e9,
            }
    return {"totals_us": dict(tot), "counts": dict(cnt), "meta": meta,
            "parents": dict(parents), "file": files[-1]}


def main():
    max_iter = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    import bench

    trace_dir = os.path.join(_repo, "chiprun_out", "giant_m_trace")
    rate, n_iter, exit_code, t_act, _peak = bench.bench_giant_m(
        max_iter=max_iter, trace_dir=trace_dir)
    print(f"giant-m: {rate:.2f} iters/s, n_iter={n_iter}, "
          f"exit={exit_code}, t_active={t_act}")

    agg = parse_trace(trace_dir)
    tot = agg["totals_us"]
    total_ms = sum(tot.values()) / 1e3
    bodies = max(n_iter + 1, 1)  # loop bodies executed (first iter folded)
    print(f"\ntrace: {agg['file']}")
    for pname, us in sorted(agg["parents"].items(), key=lambda kv: -kv[1]):
        print(f"parent {pname}: {us / 1e3:.1f} ms")
    print(f"leaf-op total: {total_ms:.1f} ms over {bodies} bodies "
          f"({total_ms / bodies:.2f} ms/body)\n")
    hdr = (f"{'op':42s} {'ms/body':>8s} {'GB':>6s} {'GB/s':>6s} "
           f"{'GFLOP':>7s} {'source':40s}")
    print(hdr)
    for name, us in sorted(tot.items(), key=lambda kv: -kv[1])[:32]:
        m = agg["meta"][name]
        per = us / bodies / 1e3
        n_exec = agg["counts"][name]
        gbs = m["gb"] * n_exec / (us / 1e6) if us else 0.0
        print(f"{name[:42]:42s} {per:8.2f} {m['gb']:6.2f} {gbs:6.0f} "
              f"{m['gflops']:7.2f} {m['source'][-40:]:40s}")


if __name__ == "__main__":
    main()
