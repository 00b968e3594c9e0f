"""Packed host↔device transfer.

`jax.device_put` on a pytree issues one transfer per leaf; over a
latency-bound link a family of small per-instance arrays pays the
round-trip latency once PER LEAF.  The packing was chosen on the earlier
accelerator, whose host link made that latency dominate the batched-small
pipeline; on the H100's PCIe link it is not yet measured (ROADMAP Design
item 4).  `pack_device_put` concatenates all same-dtype
leaves into one flat buffer on the source device, ships it in a single
transfer, and re-slices it on the target with static offsets (one trivial
fused XLA program, compiled once per structure).
"""
from __future__ import annotations

import functools

import jax
import numpy as np
from jax import lax

Array = jax.Array


@functools.partial(jax.jit, static_argnums=(1, 2))
def _unpack(flat: Array, offsets_sizes: tuple, shapes: tuple):
    return [
        lax.slice(flat, (off,), (off + size,)).reshape(shape)
        for (off, size), shape in zip(offsets_sizes, shapes)
    ]


def pack_device_put(tree, device):
    """device_put a pytree in one transfer per dtype group.

    Leaves are pulled to host (numpy — so packing never dispatches compute
    to the default device), grouped by dtype, raveled, concatenated,
    transferred once per group, and re-sliced on `device`.  Ordering and
    structure are preserved exactly.
    """
    leaves, treedef = jax.tree.flatten(tree)
    if not leaves:
        return tree
    leaves_h = [np.asarray(l) for l in leaves]
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves_h):
        by_dtype.setdefault(leaf.dtype, []).append(i)

    out = [None] * len(leaves)
    for dtype, idxs in by_dtype.items():
        if len(idxs) == 1:
            out[idxs[0]] = jax.device_put(leaves_h[idxs[0]], device)
            continue
        flat = np.concatenate([np.ravel(leaves_h[i]) for i in idxs])
        flat_d = jax.device_put(flat, device)
        offs, sizes, shapes = [], [], []
        off = 0
        for i in idxs:
            a = leaves_h[i]
            offs.append(off)
            sizes.append(a.size)
            shapes.append(a.shape)
            off += a.size
        parts = _unpack(flat_d, tuple(zip(offs, sizes)), tuple(shapes))
        for i, p in zip(idxs, parts):
            out[i] = p
    return jax.tree.unflatten(treedef, out)
