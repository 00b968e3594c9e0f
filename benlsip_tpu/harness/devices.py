"""Device lookup helpers.

`require_gpu()` is the check every measurement script makes before it
times anything: a number taken on the CPU must never pass for a device
number, so a script that finds no GPU fails instead of falling back.

`jax.devices("cpu")[0]` returns the first CPU device of the GLOBAL device
list — under `jax.distributed` that device belongs to process 0 and is
non-addressable from every other process ("Cannot copy array to
non-addressable device"), which broke the mixed-precision pipeline's host
phases in multi-host runs.  Every host-placement site goes through
`local_cpu()` instead.
"""
from __future__ import annotations

import jax


def local_cpu() -> jax.Device:
    """This process's own CPU device (multi-process safe)."""
    return jax.local_devices(backend="cpu")[0]


def device_record() -> dict:
    """{"platform", "kind", "count"} of JAX's default backend: the device
    record printed beside every measured result."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def require_gpu() -> dict:
    """`device_record()`, or RuntimeError when the backend is not a GPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {rec['platform']!r}; "
            "device measurements need the card"
        )
    return rec
