"""Device events into the registry, attributed to the open span
(counterpart of ``raft_tpu.obs.xla_events``).

raft_tpu listens to ``jax.monitoring`` for XLA compiles, compilation-cache
hits and host↔device transfers.  The port has no XLA; what takes their
place is counted where it happens, under raft_tpu's family names:

- ``backend_compile`` — a kernel build: one ``nvcc`` compile of a
  ``csrc/*.cu`` source (``kernels.build``, run on first use), with the
  wall seconds of that source's own compile:
  ``raft_tpu_kernel_builds_total{span=}`` and
  ``raft_tpu_kernel_build_seconds``.  The sources compile side by side, so
  their seconds overlap: a span's ``kernel_build_seconds`` is their sum,
  not the build's wall;
- ``cache_hit`` / ``cache_miss`` — loading the kernel library
  (``kernels.library``): a hit when an up-to-date build was already on
  disk, a miss when this process had to build it:
  ``raft_tpu_kernel_library_total{result=}``;
- ``transfer`` — a host↔device copy made through ``core.resources``
  (``to_device``, ``as_f32``, ``to_numpy``):
  ``raft_tpu_transfer_events_total{span=,direction=}`` and
  ``raft_tpu_transfer_bytes_total{direction=}``.

Each is also added to the innermost open span's events (``kernel_builds``,
``kernel_build_seconds``, ``kernel_cache_hit`` / ``kernel_cache_miss``,
``transfers``, ``transfer_bytes``).  Nothing is counted while obs is
disabled (``obs.set_enabled(False)``).

Listeners (:func:`add_listener`) hear every event on the thread that
recorded it, obs enabled or not: the serving layer's per-thread build
counter (``serve.metrics.compile_count``) is one.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from raft_tpu_torch.obs import spans as _spans
from raft_tpu_torch.obs.registry import default_registry

#: kernel-build histogram ladder: 10 ms .. ~160 s (seconds)
_BUILD_BUCKETS = tuple(0.01 * (2.0 ** i) for i in range(15))

FAMILIES = ("backend_compile", "cache_hit", "cache_miss", "transfer")

_listeners: List[Callable[[str], None]] = []


def add_listener(fn: Callable[[str], None]) -> None:
    """Call ``fn(family)`` on the recording thread for every event from now
    on (idempotent per function)."""
    if fn not in _listeners:
        _listeners.append(fn)


def record(family: str, *, seconds: Optional[float] = None, nbytes: int = 0,
           direction: Optional[str] = None) -> None:
    """Book one event of ``family`` against the innermost open span."""
    if family not in FAMILIES:
        raise ValueError(f"unknown device-event family {family!r}; known: {FAMILIES}")
    for fn in tuple(_listeners):
        fn(family)
    if not _spans.enabled():
        return
    reg = default_registry()
    sp = _spans.current_span()
    span_name = sp.name if sp is not None else "(no span)"
    if family == "backend_compile":
        reg.counter("raft_tpu_kernel_builds_total",
                    help="kernel source builds (nvcc), by enclosing traced span"
                    ).inc(span=span_name)
        if seconds is not None:
            reg.histogram("raft_tpu_kernel_build_seconds", help="wall seconds of one kernel source's nvcc compile "
                          "(the sources compile side by side)",
                          buckets=_BUILD_BUCKETS).observe(seconds)
        if sp is not None:
            sp.add_event("kernel_builds")
            if seconds is not None:
                sp.add_event("kernel_build_seconds", seconds)
    elif family in ("cache_hit", "cache_miss"):
        result = family.split("_")[1]
        reg.counter("raft_tpu_kernel_library_total",
                    help="kernel library loads: hit = an up-to-date build was on disk"
                    ).inc(result=result)
        if sp is not None:
            sp.add_event(f"kernel_cache_{result}")
    else:
        reg.counter("raft_tpu_transfer_events_total",
                    help="host<->device copies through core.resources"
                    ).inc(span=span_name, direction=str(direction))
        reg.counter("raft_tpu_transfer_bytes_total",
                    help="bytes of host<->device copies through core.resources"
                    ).inc(float(nbytes), direction=str(direction))
        if sp is not None:
            sp.add_event("transfers")
            sp.add_event("transfer_bytes", float(nbytes))


def record_copy(src_device, dst_device, nbytes: int) -> None:
    """Book a copy between two devices when exactly one of them is the
    host (a copy within the host or within the card is no transfer)."""
    src_host = src_device.type == "cpu"
    dst_host = dst_device.type == "cpu"
    if src_host != dst_host:
        record("transfer", nbytes=int(nbytes), direction="h2d" if src_host else "d2h")
