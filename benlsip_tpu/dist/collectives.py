"""Thin mesh-aware collectives wrapper.

SURVEY.md §2.5/§5 requires the communication backend as a first-class,
nameable component: JAX collectives over ICI/DCN replace the reference's
(nonexistent) MPI/NCCL layer.  The declarative sharding paths
(`dist/sharded.py`) never call these — XLA inserts collectives — while the
explicit-collectives blocked mode (`solve_large_blocked_shardmap`) reaches
them through `SolverOptions.spmd_axis`: `psum` for every d-contraction,
`psum_scatter`/`ring_psum_scatter` + `all_gather` for the row-sharded Gram
layout (`ops/al.with_gram_rows`).  One module so the solver core stays
mesh-agnostic.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array


def psum(x, axis: str):
    """Sum across a mesh axis — CG inner products rᵀv, pᵀHp
    (reference scalars at `src/basic_tralcnlss.jl:723, 732, 743`)."""
    return lax.psum(x, axis)


def pmean(x, axis: str):
    return lax.pmean(x, axis)


def all_gather(x, axis: str, *, tiled: bool = True):
    """Gather shards along a mesh axis — step assembly at matvec boundaries."""
    return lax.all_gather(x, axis, tiled=tiled)


def psum_scatter(x, axis: str, *, tiled: bool = True):
    """Reduce-scatter — blockwise JᵀJ partial-product accumulation."""
    return lax.psum_scatter(x, axis, tiled=tiled)


def ppermute_ring(x, axis: str, shift: int = 1):
    """Ring shift along a mesh axis (the ring-accumulation building block)."""
    n = lax.axis_size(axis)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return lax.ppermute(x, axis, perm)


def ring_psum_scatter(x, axis: str):
    """Hand-scheduled ring reduce-scatter over the leading axis of `x`.

    Semantically identical to `psum_scatter(x, axis, tiled=True)` — device i
    ends with rows [i·n/D, (i+1)·n/D) of the cross-device sum — but built
    from D−1 explicit `ppermute` hops, each moving one (n/D, …) chunk one
    step around the ring while the receiver adds its local contribution.
    This is the ring/blockwise-accumulation pattern SURVEY.md §5 maps onto
    this domain (the structural analog of ring attention): per-device wire
    traffic is (D−1)/D of the full array, half a psum's 2(D−1)/D, and the
    unrolled schedule exposes each add/permute pair to XLA's async
    collective overlap instead of one monolithic reduce.

    Invariant: at step t device j sends the partial sum of chunk
    (j−1−t) mod D accumulated over devices j−t..j; after D−1 hops chunk j
    has visited every device and rests, fully reduced, at device j.
    """
    D = lax.axis_size(axis)
    if x.shape[0] % D:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by ring size {D}")
    rows = x.shape[0] // D
    idx = lax.axis_index(axis)

    def chunk(c):
        return lax.dynamic_slice_in_dim(x, c * rows, rows, axis=0)

    buf = chunk((idx - 1) % D)
    for t in range(D - 1):  # D is static: unrolled so XLA can overlap hops
        buf = ppermute_ring(buf, axis, 1)
        buf = buf + chunk((idx - 2 - t) % D)
    return buf


def ring_psum_scatter_lazy(make_chunk, axis: str, operand=None):
    """Ring reduce-scatter whose local contributions are built LAZILY.

    Same schedule and result as `ring_psum_scatter`, but the caller's full
    local array never exists: `make_chunk(c, operand)` (c a traced chunk
    index in [0, D)) materializes just this device's contribution to
    global chunk c at the moment the ring needs it.  Peak live memory is
    two chunks (the travelling buffer + the freshly built contribution)
    instead of the whole D-chunk local partial — the build-transient fix
    for the row-sharded Gram layout (ops/al.with_gram_rows), where the
    dense partial JᵀJ is (n, n) but each contribution is only (n/D, n).

    Unlike `ring_psum_scatter` the hops here run under a `lax.fori_loop`,
    and that is LOAD-BEARING for the memory claim: unrolled, the chunk
    builds have no data dependency on the travelling buffer, so XLA's
    scheduler hoists ALL of them ahead of the first hop — measured on the
    n=20480 8-device compile, the unrolled 'lazy' build's temp arena was
    the full n² (1.68 GB), identical to the eager schedule, and
    `lax.optimization_barrier` did not survive to the scheduled HLO.  A
    loop body exists once, so peak live memory is provably one buffer +
    one chunk + `operand` (tests/test_blocked_shardmap.py asserts the
    compiled buffer stats).  The cost is that hops can no longer overlap
    each other — the right trade at the n where this schedule is
    mandatory, since the eager build does not fit at all.

    `operand` is the data `make_chunk` reads (e.g. J), threaded through
    the loop explicitly.
    """
    D = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    buf0 = make_chunk((idx - 1) % D, operand)

    def body(t, buf):
        buf = ppermute_ring(buf, axis, 1)
        return buf + make_chunk((idx - 2 - t) % D, operand)

    return lax.fori_loop(0, D - 1, body, buf0)


def axis_index(axis: str):
    return lax.axis_index(axis)


def initialize_distributed(**kwargs) -> None:
    """Multi-host bring-up: `jax.distributed.initialize` passthrough.

    Each host calls this before building the global mesh.  Without
    arguments JAX discovers the cluster from a launcher it knows (SLURM,
    Open MPI); elsewhere pass `coordinator_address`, `num_processes` and
    `process_id`.
    """
    jax.distributed.initialize(**kwargs)
