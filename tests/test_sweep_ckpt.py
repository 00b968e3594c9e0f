"""Sweep-level checkpoint/resume under real preemption (SIGKILL).

The config-5 capability (SURVEY.md §5 checkpoint row): a large chunked
sweep killed mid-flight must resume from its orbax checkpoints and finish
with results bit-identical to an uninterrupted run.  The kill here is a
real SIGKILL of a subprocess worker (tests/sweep_worker.py) — no graceful
shutdown path runs.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from benlsip_tpu.harness.sweep import CheckpointedSweep, run_sweep
from benlsip_tpu.problems.generators import exp_fit_family
from benlsip_tpu.solver.options import SolverOptions

B = 96
SWEEP_CHUNK = 16  # 6 chunks
OPTS = SolverOptions(max_outer_iter=40, max_inner_iter=120)


def _family():
    return exp_fit_family(B, d=32, seed=11)


def test_sweep_resume_bit_identical_after_sigkill(tmp_path):
    bp, theta, X0 = _family()

    # Uninterrupted run (checkpointed, fresh directory).
    X_ref, Y_ref, info_ref, resumed = run_sweep(
        bp, theta, X0, OPTS, str(tmp_path / "a"),
        sweep_chunk=SWEEP_CHUNK, mixed_precision=False,
    )[:4]
    assert resumed == 0
    assert bool(np.all(info_ref.converged))

    # Worker sweep into dir b, throttled 30 s/chunk; SIGKILL it as soon as
    # its first checkpoint lands (mid-sweep by construction: 6 chunks).
    bdir = tmp_path / "b"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(__file__), "sweep_worker.py"),
         str(bdir), str(B), str(SWEEP_CHUNK), "30"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.time() + 300
        first_step = None
        while time.time() < deadline:
            if proc.poll() is not None:
                out = proc.stdout.read().decode()
                pytest.fail(f"worker exited before kill (rc={proc.returncode}):\n{out[-2000:]}")
            steps = [p for p in (os.listdir(bdir) if bdir.exists() else []) if p.isdigit()]
            if steps:
                first_step = max(int(s) for s in steps)
                break
            time.sleep(0.5)
        assert first_step is not None, "worker produced no checkpoint within 300 s"
        # Let the async save finish writing, then kill — exact PID, no pattern.
        time.sleep(2.0)
        proc.send_signal(signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()

    # Resume in-process and finish.
    sweep = CheckpointedSweep(
        bp, OPTS, str(bdir), sweep_chunk=SWEEP_CHUNK, mixed_precision=False
    )
    X2, Y2, info2, resumed_from = sweep.run(theta, X0)
    assert 1 <= resumed_from < B // SWEEP_CHUNK, (
        f"kill did not land mid-sweep (resumed_from={resumed_from})"
    )
    # Bit-identical to the uninterrupted run: same chunk slices, same
    # compiled program, exact f64 save/restore.
    assert np.array_equal(X2, X_ref)
    assert np.array_equal(Y2, Y_ref)
    assert np.array_equal(info2.pix, info_ref.pix)


def test_sweep_stop_after_chunks_resumes(tmp_path):
    # In-process preemption simulation (no subprocess): stop_after_chunks
    # raises mid-sweep; a fresh CheckpointedSweep on the same directory
    # resumes and matches a straight run.
    bp, theta, X0 = _family()
    d = str(tmp_path / "c")
    sweep = CheckpointedSweep(bp, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False)
    with pytest.raises(RuntimeError, match="resume"):
        sweep.run(theta, X0, stop_after_chunks=2)
    X2, Y2, info2, resumed_from = CheckpointedSweep(
        bp, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False
    ).run(theta, X0)
    assert resumed_from == 2
    X_ref, Y_ref, info_ref, _ = CheckpointedSweep(
        bp, OPTS, str(tmp_path / "ref"), sweep_chunk=SWEEP_CHUNK, mixed_precision=False
    ).run(theta, X0)
    assert np.array_equal(X2, X_ref) and np.array_equal(Y2, Y_ref)


def test_sweep_refuses_geometry_mismatch_on_resume(tmp_path):
    """A checkpoint written with one (B, sweep_chunk) must not resume a run
    with another: step k means 'chunks [0,k) of THAT partition are done',
    so a silent resume would return zero buffers as results."""
    bp, theta, X0 = _family()
    d = str(tmp_path / "geom")
    sweep = CheckpointedSweep(bp, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False)
    with pytest.raises(RuntimeError):
        sweep.run(theta, X0, stop_after_chunks=2)

    # Same directory, different chunking -> refuse.
    bad = CheckpointedSweep(bp, OPTS, d, sweep_chunk=2 * SWEEP_CHUNK, mixed_precision=False)
    with pytest.raises(ValueError, match="geometr"):
        bad.run(theta, X0)

    # Same directory, different B -> refuse.
    bp2, theta2, X02 = _family()
    half = slice(0, B // 2)
    import jax as _jax
    with pytest.raises(ValueError, match="geometr"):
        CheckpointedSweep(bp2, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False).run(
            _jax.tree.map(lambda a: a[half], theta2), X02[half]
        )

    # Matching geometry still resumes and completes.
    X, Y, info, resumed = sweep.run(theta, X0)
    assert resumed == 2 and bool(np.all(info.converged))


def test_sweep_resume_after_midchunk_sigkill(tmp_path):
    """Arbitrary-point preemption (VERDICT r2 #7): the kill lands DURING a
    chunk's compute (immediately after its start marker), not at the
    post-checkpoint drain.  Resume must recompute the in-flight chunk
    idempotently — chunk inputs are pure slices of (theta, X0) — and
    finish bit-identical to an uninterrupted run (bench_ckpt.py kills
    between chunks; this kills mid-chunk)."""
    bp, theta, X0 = _family()
    X_ref, Y_ref, info_ref, _ = run_sweep(
        bp, theta, X0, OPTS, str(tmp_path / "ref"),
        sweep_chunk=SWEEP_CHUNK, mixed_precision=False,
    )[:4]

    bdir = tmp_path / "mid"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(__file__), "sweep_worker.py"),
         str(bdir), str(B), str(SWEEP_CHUNK), "0", "markers"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    killed_at = None
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            line = proc.stdout.readline().decode()
            if not line:
                pytest.fail(f"worker exited before kill (rc={proc.poll()})")
            if line.startswith("CHUNK_START"):
                k = int(line.split()[1])
                if k >= 1:
                    # Chunk k's compute is under way; its checkpoint commit
                    # is strictly later.  Kill NOW — exact PID, no pattern.
                    proc.send_signal(signal.SIGKILL)
                    killed_at = k
                    break
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    assert killed_at is not None

    # The in-flight chunk's checkpoint must not have committed: the latest
    # step is at most killed_at (= chunks [0, killed_at) done).
    sweep = CheckpointedSweep(
        bp, OPTS, str(bdir), sweep_chunk=SWEEP_CHUNK, mixed_precision=False
    )
    X2, Y2, info2, resumed_from = sweep.run(theta, X0)
    assert resumed_from <= killed_at, (
        f"kill after CHUNK_START {killed_at} but checkpoint {resumed_from} committed"
    )
    assert np.array_equal(X2, X_ref)
    assert np.array_equal(Y2, Y_ref)
    assert np.array_equal(info2.pix, info_ref.pix)
