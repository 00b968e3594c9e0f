"""Loop execution strategies for the jitted state machines.

`lax.while_loop` has fixed per-iteration scheduling overhead (on the GPU,
a host round trip for the predicate and separate kernel launches per
iteration) and blocks cross-iteration fusion; for the batched-small regime the inner
loops (Cauchy breakpoint walk, projected CG, minor iterations, projection
Newton) have tiny static trip bounds (O(n) with n ≤ ~16), so running them
as masked *unrolled* loops — every trip emitted as straight-line code,
finished lanes frozen by selects — trades a few wasted vector ops for the
elimination of all loop dispatch.  `run_bounded` picks the strategy from a
static trip bound.
"""
from __future__ import annotations

from typing import Callable, TypeVar

import jax
import jax.numpy as jnp
from jax import lax

T = TypeVar("T")


def run_bounded(
    cond: Callable[[T], jax.Array],
    body: Callable[[T], T],
    init: T,
    max_trips: int,
    unroll_limit: int | None = None,
) -> T:
    """while(cond) body, with trip count statically bounded by max_trips.

    For small static bounds (max_trips ≤ unroll_limit) the loop is fully
    unrolled with masking: `body` must be safe to evaluate on an
    already-finished carry (all our loop bodies are where-select state
    machines, so they are).  The threshold is plumbed from
    `SolverOptions.unroll_limit` (compiled-program identity belongs in the
    config contract, not module state); None/0 means always while_loop —
    the default chosen on the earlier accelerator, where unrolled
    programs compiled far slower for no warm gain; not yet measured on
    the H100 (ROADMAP Speed item 3).  tests/test_loops.py keeps both
    strategies parity-checked.
    """
    if unroll_limit is None:
        unroll_limit = 0
    max_trips = int(max_trips)
    if max_trips <= 0:
        return init
    if max_trips > unroll_limit:
        return lax.while_loop(cond, body, init)

    c = init
    for _ in range(max_trips):
        nxt = body(c)
        keep = cond(c)
        c = jax.tree.map(lambda new, old: jnp.where(keep, new, old), nxt, c)
    return c
