"""Multi-host bring-up smoke test (SURVEY.md §4: multi-host tests runnable
on CPU without a pod): two jax.distributed processes, each with 4 virtual
devices, solve a DP-sharded global batch over the 8-device mesh."""
import os
import subprocess
import sys

import pytest


@pytest.mark.slow
def test_two_process_dp_solve():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "mh_worker.py")
    port = "12356"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=os.path.dirname(here),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-2000:]}"
        assert f"proc {pid}: OK" in out, out[-2000:]


def run_mh_sweep(B=256, chunk=32, port="12357", timeout=420):
    """Launch the 2-process sweep-efficiency workers; returns the parsed
    per-process reports (tests/mh_sweep_worker.py)."""
    import json

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "mh_sweep_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port, str(B), str(chunk)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=os.path.dirname(here),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError("mh sweep worker timed out")
        outs.append(out)
    reports = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-2000:]}"
        row = [ln for ln in out.splitlines() if ln.startswith("MHSWEEP ")]
        assert row, f"proc {pid} emitted no MHSWEEP row:\n{out[-2000:]}"
        reports.append(json.loads(row[-1][len("MHSWEEP "):]))
    return reports


@pytest.mark.slow
def test_two_process_sweep_efficiency():
    """Measured (not modeled) N-host efficiency for the config-5 execution
    shape (VERDICT r2 #5): each process solves its local shard's chunks as
    independent programs; efficiency = mean(total wall)/max(total wall)
    across processes.  The only predicted loss term is chunk-wall spread; with an iid workload split evenly the spread should
    be modest even on a contended 2-core host."""
    reports = run_mh_sweep()
    totals = [r["total_wall_s"] for r in reports]
    eff = (sum(totals) / len(totals)) / max(totals)
    conv = sum(r["converged"] for r in reports)
    B = sum(r["local_B"] for r in reports)
    print(f"2-process sweep: totals={totals} efficiency={eff:.3f} conv={conv}/{B}")
    assert conv == B
    # Loose floor: the two processes share 2 physical cores here, so OS
    # scheduling noise is the dominant spread source; on real hosts each
    # process has its own cores and the spread is the workload's own.
    assert eff >= 0.5, f"efficiency {eff:.3f} below floor; totals={totals}"


@pytest.mark.slow
def test_two_process_mixed_precision_pipeline():
    """The FULL mixed-precision pipeline (bulk + fused/host polish +
    certification) runs per-process under jax.distributed — the round-4
    multi-process hardening: host placement via jax.local_devices (the
    global jax.devices()[0] belongs to process 0 and is non-addressable
    elsewhere).  Drives examples/multihost_sweep.py 2-process and asserts
    every instance on every host certifies."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(os.path.dirname(here), "examples", "multihost_sweep.py")
    procs = [
        subprocess.Popen(
            [sys.executable, script, "--pid", str(pid), "--nprocs", "2",
             "--port", "12413", "--B", "128", "--chunk", "64"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=os.path.dirname(here),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError("pipeline worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-2000:]}"
        assert f"[host {pid}/2] 64/64 certified" in out, out[-500:]
