"""Config-5 checkpoint/resume exercise on the GPU (VERDICT r1 item 8).

Runs the config-5 sweep (exp-fit family, mixed-precision pipeline) as a
checkpointed sweep three times:

  A. uninterrupted, fresh directory  — the reference result;
  B. same sweep, fresh directory, SIGKILLed (exact child PID) right after
     its first chunk checkpoint lands — a real preemption;
  C. resume of B's directory to completion, then bit-compare against A's
     final checkpoint.

The orchestrator (this process) never initializes JAX: all device work
happens in subprocess workers (`worker` mode below), so the card is owned
by exactly one process at a time.  Prints one row, and appends it to
--out when given:

  {"config": 5, "case": "ckpt_resume_B<N>", "bit_identical": true,
   "resumed_from_chunk": k, "device": {...}, ...}

Usage:  python bench_ckpt.py [--B 16384] [--full] [--out FILE]
Workers fail without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time


def worker(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--B", type=int, required=True)
    ap.add_argument("--sweep-chunk", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--throttle", type=float, default=0.0)
    ap.add_argument("--compare-dir", default=None)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)

    import math

    import numpy as np

    from benlsip_tpu.harness.cache import enable_compile_cache
    from benlsip_tpu.harness.devices import require_gpu

    device = require_gpu()
    enable_compile_cache()

    from benlsip_tpu.harness.sweep import CheckpointedSweep
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    bp, theta, X0 = exp_fit_family(args.B, d=32, seed=7, dtype=jax.numpy.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    sweep = CheckpointedSweep(
        bp, opts, args.dir, sweep_chunk=args.sweep_chunk, chunk=args.chunk,
        mixed_precision=True, throttle_s=args.throttle,
    )
    t0 = time.perf_counter()
    X, Y, info, resumed = sweep.run(theta, X0)
    wall = time.perf_counter() - t0

    row = {
        "B": args.B,
        "wall_s": round(wall, 3),
        "resumed_from_chunk": resumed,
        "chunks": math.ceil(args.B / args.sweep_chunk),
        "converged_frac": round(float(np.mean(info.converged)), 4),
        "device": device,
    }
    if args.compare_dir:
        ref = CheckpointedSweep(
            bp, opts, args.compare_dir, sweep_chunk=args.sweep_chunk,
            chunk=args.chunk,
        )
        X_ref, Y_ref, info_ref, _ = ref.run(theta, X0)  # all-done: pure restore
        row["bit_identical"] = bool(
            np.array_equal(X, X_ref)
            and np.array_equal(Y, Y_ref)
            and np.array_equal(info.pix, info_ref.pix)
        )
    print("WORKER_ROW " + json.dumps(row), flush=True)


def _spawn(dir_, B, sweep_chunk, chunk, throttle=0.0, compare=None):
    cmd = [sys.executable, os.path.abspath(__file__), "worker",
           "--dir", dir_, "--B", str(B), "--sweep-chunk", str(sweep_chunk),
           "--chunk", str(chunk), "--throttle", str(throttle)]
    if compare:
        cmd += ["--compare-dir", compare]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _finish(proc, tag):
    out = proc.stdout.read().decode()
    if proc.returncode != 0:
        sys.stderr.write(out[-4000:])
        raise RuntimeError(f"{tag} worker failed rc={proc.returncode}")
    for line in out.splitlines():
        if line.startswith("WORKER_ROW "):
            return json.loads(line[len("WORKER_ROW "):]), out
    sys.stderr.write(out[-4000:])
    raise RuntimeError(f"{tag} worker emitted no row")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=16384)
    ap.add_argument("--full", action="store_true", help="sweep scale: B=102400")
    ap.add_argument("--sweep-chunk", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--out", default=None, help="also append the row to this JSONL file")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    args = ap.parse_args()
    B = 102400 if args.full else args.B

    workdir = args.workdir or tempfile.mkdtemp(prefix="benlsip_ckpt_")
    shutil.rmtree(workdir, ignore_errors=True)
    da, db = os.path.join(workdir, "a"), os.path.join(workdir, "b")
    os.makedirs(da), os.makedirs(db)

    # A: uninterrupted.
    pa = _spawn(da, B, args.sweep_chunk, args.chunk)
    pa.wait()
    row_a, _ = _finish(pa, "A")
    print("A (uninterrupted):", json.dumps(row_a), flush=True)

    # B: throttled so the kill window after checkpoint 1 is wide, then
    # SIGKILL the exact child PID once its first checkpoint directory lands.
    pb = _spawn(db, B, args.sweep_chunk, args.chunk, throttle=60.0)
    deadline = time.time() + 1800
    killed_at_step = None
    while time.time() < deadline:
        if pb.poll() is not None:
            _finish(pb, "B")  # raises with its log
            raise RuntimeError("B worker finished before the kill — widen throttle")
        steps = [int(p) for p in os.listdir(db) if p.isdigit()]
        if steps:
            killed_at_step = max(steps)
            break
        time.sleep(1.0)
    assert killed_at_step is not None, "no checkpoint appeared within 30 min"
    time.sleep(5.0)  # let the async orbax commit finish
    pb.send_signal(signal.SIGKILL)
    pb.wait()
    pb.stdout.read()
    print(f"B killed after checkpoint step {killed_at_step}", flush=True)

    # C: resume B's directory, compare against A's final state.
    pc = _spawn(db, B, args.sweep_chunk, args.chunk, compare=da)
    pc.wait()
    row_c, _ = _finish(pc, "C")
    print("C (resumed):", json.dumps(row_c), flush=True)

    assert row_c["resumed_from_chunk"] >= 1, "resume did not pick up the checkpoint"
    assert row_c["bit_identical"], "resumed result differs from uninterrupted run"

    row = {
        "config": 5,
        "case": f"ckpt_resume_B{B}",
        "bit_identical": row_c["bit_identical"],
        "resumed_from_chunk": row_c["resumed_from_chunk"],
        "chunks": row_c["chunks"],
        "killed_at_step": killed_at_step,
        "wall_uninterrupted_s": row_a["wall_s"],
        "wall_resumed_s": row_c["wall_s"],
        "converged_frac": row_c["converged_frac"],
        "device": row_c["device"],
        "ts": time.time(),
    }
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(sys.argv[2:])
    else:
        main()
