"""Multi-process scaling measurement (BASELINE target: >=85% rays/s scaling
efficiency at 2 hosts; the reference's qualitative claim is "very good
speedup" up to 6 GPUs over GbE, in its README.md:21).

Runs the same iteration-sharded job with 1 and N processes joined by
jax.distributed on a localhost coordinator, and prints one JSON line per
method. On the CPU (default) each process is one "host" with one device,
pinned to one core; with ``--platform cuda`` each worker gets its own card
(tests/distributed_worker.py), so N must not exceed the cards. Usage:

    python scripts/scaling_bench.py [--nproc 2] [--iters 16] [--size 64]
        [--method pt,ppm] [--platform cpu|cuda]
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "distributed_worker.py"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_farm(nproc, iters, size, method, platform="cpu"):
    """On the CPU every worker is pinned to ONE core via taskset so the
    1-process baseline and each of the N workers run on identical hardware
    — without it, single-process XLA already consumes every core and an
    N-process run cannot show speedup regardless of protocol efficiency
    (what is measured is the iteration-sharding protocol)."""
    pin_cores = platform == "cpu"
    port = free_port()
    out = Path(tempfile.mkdtemp()) / "merged.npz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = platform
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    ncores = os.cpu_count() or 1
    procs = []
    for i in range(nproc):
        cmd = [sys.executable, str(WORKER), str(i), str(nproc), str(port),
               str(out), str(iters), str(size), method]
        if pin_cores:
            cmd = ["taskset", "-c", str(i % ncores)] + cmd
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(REPO)))
    for p in procs:
        p.wait(timeout=1200)
        assert p.returncode == 0, f"worker failed rc={p.returncode}"
    z = np.load(out)
    return float(z["seconds"]), z


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--method", default="pt",
                    help="comma list, e.g. pt,ppm")
    ap.add_argument("--platform", default="cpu", choices=["cpu", "cuda"],
                    help="cuda: one card per worker process")
    args = ap.parse_args()

    results = []
    for method in args.method.split(","):
        iters = args.iters if method == "pt" else max(4, args.iters // 2)
        t1, _z1 = run_farm(1, iters, args.size, method, args.platform)
        tn, zn = run_farm(args.nproc, iters, args.size, method,
                          args.platform)
        merge_s = float(zn["merge_seconds"])
        results.append({
            "method": method, "iterations": iters,
            "resolution": f"{args.size}x{args.size}",
            "seconds_1proc": round(t1, 3),
            f"seconds_{args.nproc}proc": round(tn, 3),
            "speedup": round(t1 / tn, 3),
            "scaling_efficiency": round(t1 / tn / args.nproc, 4),
            "merge_seconds": round(merge_s, 3),
            "protocol_overhead_fraction": round(merge_s / tn, 4),
            "backend": f"{args.platform} (localhost jax.distributed)",
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        })
        print(json.dumps(results[-1]), flush=True)


if __name__ == "__main__":
    main()
