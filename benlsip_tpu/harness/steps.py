"""What a solve dispatched, kept while a `record_steps()` block is open.

The batched pipelines report here:

- each jitted program they launch (the chunked bulk solve, the
  whole-pipeline fused program, the fused certification, the blocked
  solve), with its arguments, in dispatch order, so a caller can lower
  exactly the program that ran — for its `compiled.memory_analysis()`,
  say — instead of rebuilding it from the pipeline's options;
- the lanes the host full-refine fallback took (`batch/polish.py`), so
  no device result hides behind host work.

Outside a `record_steps()` block each report costs one ContextVar read.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class StepRecord:
    """`programs`: (name, jitted program, args) per dispatch, in order."""

    programs: List[Tuple[str, Callable, Tuple[Any, ...]]] = dataclasses.field(
        default_factory=list)
    fallback_lanes: int = 0


_ACTIVE: contextvars.ContextVar[Optional[StepRecord]] = contextvars.ContextVar(
    "benlsip_step_record", default=None)


@contextlib.contextmanager
def record_steps() -> Iterator[StepRecord]:
    """Collect what the solves inside the block dispatch."""
    rec = StepRecord()
    token = _ACTIVE.set(rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)


def dispatch(name: str, program: Callable, *args):
    """`program(*args)`, noted in the open record, if any."""
    rec = _ACTIVE.get()
    if rec is not None:
        rec.programs.append((name, program, args))
    return program(*args)


def note_fallback(lanes: int) -> None:
    """Add `lanes` host-fallback lanes to the open record, if any."""
    rec = _ACTIVE.get()
    if rec is not None:
        rec.fallback_lanes += lanes
