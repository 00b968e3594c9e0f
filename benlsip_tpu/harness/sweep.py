"""Checkpointed large sweeps (BASELINE config 5): chunk-granular resume.

`CheckpointedSolve` (harness/checkpoint.py) checkpoints the solver *carry*
mid-solve — the right grain for one long-running instance.  A 100k-instance
sweep's natural grain is the **chunk**: the sweep is a sequence of
independent, deterministic chunk solves (the mixed-precision pipeline,
batch/refine.py), so checkpointing completed chunks' *results* makes
resume trivially bit-identical — a resumed sweep recomputes nothing that
was saved and computes the remaining chunks with the same compiled
programs on the same inputs as an uninterrupted run would.

The reference never needs any of this (its solves are seconds-long,
SURVEY.md §5 — the whole capability is new, required by pod-scale sweeps
where preemption is routine).

Orbax note: leaves are converted to host numpy before `StandardSave`:
the sweep state is pure results data with no sharding to preserve, and
a host copy keeps the async save independent of the device.  Restore
therefore needs no abstract template (single-process topology, plain
numpy leaves).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import jax
import numpy as np

from ..batch.vmap_solve import BatchedProblem, _POLY_BASE_RANK
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo


def _ocp():
    import orbax.checkpoint as ocp

    return ocp


def _slice_family(bp: BatchedProblem, theta, X0, sl: slice):
    """Slice a sweep family's batched leaves (constraint fields included)."""
    upd = {
        f: getattr(bp, f)[sl]
        for f in ("A", "b", "xl", "xu")
        if getattr(bp, f) is not None
        and getattr(bp, f).ndim > getattr(_POLY_BASE_RANK, f)
    }
    bp_c = dataclasses.replace(bp, **upd) if upd else bp
    return bp_c, jax.tree.map(lambda a: a[sl], theta), X0[sl]


def _to_host(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


class CheckpointedSweep:
    """Run a chunked sweep with per-chunk orbax checkpoints; resume by
    skipping completed chunks.

    One checkpoint step = one completed sweep chunk; step k stores the
    full-size result buffers with chunks [0, k) filled.  `run()` resumes
    from the latest step if the directory holds one.
    """

    def __init__(
        self,
        bp: BatchedProblem,
        options: SolverOptions,
        directory: str,
        sweep_chunk: int = 4096,
        chunk: int = 512,
        mixed_precision: bool = True,
        pipeline_kwargs: Optional[dict] = None,
        throttle_s: float = 0.0,
    ):
        import os

        self.bp = bp
        self.options = options
        self.dir = os.path.abspath(directory)
        self.sweep_chunk = sweep_chunk
        self.chunk = chunk
        self.mixed_precision = mixed_precision
        self.pipeline_kwargs = dict(pipeline_kwargs or {})
        # Per-chunk pause after each checkpoint lands: widens the preemption
        # window for kill/resume tests (and rate-limits a shared filer).
        self.throttle_s = throttle_s
        self._mgr = _ocp().CheckpointManager(self.dir)

    def _solve_chunk(self, bp_c, theta_c, X0_c):
        if self.mixed_precision:
            from ..batch.refine import solve_mixed_precision

            return solve_mixed_precision(
                bp_c, theta_c, X0_c, self.options, chunk=self.chunk,
                **self.pipeline_kwargs,
            )
        from ..batch.vmap_solve import solve_batched_chunked

        return solve_batched_chunked(bp_c, theta_c, X0_c, self.options, chunk=self.chunk)

    def _restore(self, step: int, B: int, dtype) -> dict:
        # np.array (not asarray): buffers are written into per chunk, and
        # restore may hand back read-only leaves.  The only droppable-empty
        # leaf is Y — (B, p) with p=0 for unconstrained families; every
        # other buffer is (B,) or (B, n) with n >= 1.
        raw = dict(self._mgr.restore(step))
        # Step k means "chunks [0, k) of THIS geometry are done" — a resume
        # with a different B or sweep_chunk would silently present zero
        # buffers as results for the re-partitioned instances.  Refuse it.
        geom = raw.pop("meta_geometry", None)
        if geom is None:
            # Pre-meta_geometry checkpoint: the guard below cannot run, so a
            # stale directory resumed under a different B/sweep_chunk would
            # silently present zero-filled buffers as results.  Refuse
            # rather than guess; re-running without resume (or in a fresh
            # directory) rewrites the checkpoint with geometry metadata.
            raise ValueError(
                f"checkpoint in {self.dir} predates geometry metadata "
                "(no meta_geometry leaf): cannot verify it matches "
                f"B={B}, sweep_chunk={self.sweep_chunk}.  Resume refused — "
                "restart the sweep with resume=False or a fresh directory."
            )
        gB, gchunk = (int(v) for v in np.asarray(geom))
        if gB != B or gchunk != self.sweep_chunk:
            raise ValueError(
                f"checkpoint in {self.dir} was written with B={gB}, "
                f"sweep_chunk={gchunk}; this run has B={B}, "
                f"sweep_chunk={self.sweep_chunk} — refusing to resume "
                "across sweep geometries (use a fresh directory)"
            )
        buffers = {k: np.array(v) for k, v in raw.items()}
        if "Y" not in buffers:
            buffers["Y"] = np.zeros((B, 0), dtype)
        return buffers

    def run(
        self,
        theta,
        X0,
        resume: bool = True,
        stop_after_chunks: Optional[int] = None,
        chunk_callback=None,
    ) -> Tuple[np.ndarray, np.ndarray, SolveInfo, int]:
        """Run the sweep; returns (X, Y, info, resumed_from_chunk).

        `stop_after_chunks` bounds this call's work (for tests simulating
        preemption without a kill); the checkpoint still lands, so a later
        call resumes.  Raises RuntimeError if stopped before completion.

        `chunk_callback(k)` fires immediately BEFORE chunk k's compute —
        the hook the arbitrary-point preemption test uses to land a
        SIGKILL mid-chunk (between a chunk's start and its checkpoint
        commit); recovery then recomputes the in-flight chunk from the
        last committed step, which is idempotent because chunk inputs are
        pure slices of (theta, X0).
        """
        ocp = _ocp()
        B = X0.shape[0]
        n_chunks = math.ceil(B / self.sweep_chunk)
        if n_chunks == 0:
            raise ValueError("empty sweep: B == 0")

        start = 0
        buffers = None
        latest = self._mgr.latest_step() if resume else None
        if latest is not None:
            # Plain numpy leaves, single-process topology: template-free
            # restore is safe here (see module docstring).  np.array (not
            # asarray): the buffers are written into per chunk, and restore
            # may hand back read-only or jax-backed leaves.
            buffers = self._restore(latest, B, X0.dtype)
            start = int(latest)

        done = 0
        for k in range(start, n_chunks):
            if stop_after_chunks is not None and done >= stop_after_chunks:
                self._mgr.wait_until_finished()  # commit the in-flight save
                raise RuntimeError(
                    f"sweep stopped after {done} chunks (chunk {k}/{n_chunks}); "
                    f"checkpoint saved — rerun to resume"
                )
            if chunk_callback is not None:
                chunk_callback(k)
            sl = slice(k * self.sweep_chunk, min((k + 1) * self.sweep_chunk, B))
            bp_c, theta_c, X0_c = _slice_family(self.bp, theta, X0, sl)
            Xc, Yc, infoc = _to_host(self._solve_chunk(bp_c, theta_c, X0_c))
            if buffers is None:
                buffers = {
                    "X": np.zeros((B,) + Xc.shape[1:], Xc.dtype),
                    "Y": np.zeros((B,) + Yc.shape[1:], Yc.dtype),
                }
                for f, leaf in zip(SolveInfo._fields, infoc):
                    buffers["info_" + f] = np.zeros((B,) + leaf.shape[1:], leaf.dtype)
            buffers["X"][sl] = Xc
            buffers["Y"][sl] = Yc
            for f, leaf in zip(SolveInfo._fields, infoc):
                buffers["info_" + f][sl] = leaf
            # Orbax refuses zero-size arrays; an unconstrained family's Y is
            # (B, 0).  Drop empties on save, reconstruct on restore.
            save_dict = {b: v for b, v in buffers.items() if v.size}
            save_dict["meta_geometry"] = np.array([B, self.sweep_chunk], np.int64)
            self._mgr.save(k + 1, args=ocp.args.StandardSave(save_dict))
            done += 1
            if self.throttle_s and k + 1 < n_chunks:
                self._mgr.wait_until_finished()
                time.sleep(self.throttle_s)
        self._mgr.wait_until_finished()

        # buffers is always set here: either restored from `latest` (which
        # also covers "every chunk already checkpointed", where the loop
        # body never runs) or allocated by the first chunk (n_chunks >= 1).
        info = SolveInfo(*[buffers["info_" + f] for f in SolveInfo._fields])
        return buffers["X"], buffers["Y"], info, start


def run_sweep(
    bp: BatchedProblem,
    theta,
    X0,
    options: SolverOptions,
    directory: str,
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray, SolveInfo, int, float]:
    """One-call checkpointed sweep; returns (X, Y, info, resumed_from, wall_s)."""
    sweep = CheckpointedSweep(bp, options, directory, **kwargs)
    t0 = time.perf_counter()
    X, Y, info, resumed_from = sweep.run(theta, X0)
    return X, Y, info, resumed_from, time.perf_counter() - t0
