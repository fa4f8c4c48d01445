"""Device time of one call, for the bench's counters (counterpart of
``raft_tpu.bench.device_time``; the reference's gbench harness reports GPU
time from CUDA events beside wall time).

raft_tpu reads the busy time of an XLA device plane from a profiler dump.
Here a ``torch.profiler`` window holds exactly one call (the device is
synchronised before and after it), and the busy time is the union of the
intervals of the CUDA kernels, copies and fills the trace saw: time in
which the card did work for the call, overlapping launches counted once.
It is not the window's wall time, which CUDA events around the call would
give.  Without a card, or when the trace saw no device work (a CPU call),
the counter is None, as raft_tpu's is on a host-only backend.

The tracer now and then returns a window with every host event and no
device record at all; such a window is taken again (``TRACE_ATTEMPTS``).
``python -m raft_tpu_torch.bench.device_time`` counts those windows on the
card, and the calls that still come back without device time.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import torch

#: windows of one call taken before it counts as host-only: a window that
#: lost its device records is followed, now and then, by another that lost
#: them too
TRACE_ATTEMPTS = 4

Spans = List[Tuple[float, float]]


def busy_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals (same unit in and
    out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def first_busy(trace: Callable[[], Spans], attempts: int = TRACE_ATTEMPTS) -> Spans:
    """The spans of the first of up to ``attempts`` calls of ``trace()``
    whose union is not empty, else ``[]``."""
    for _ in range(attempts):
        spans = trace()
        if busy_seconds(spans) > 0:
            return spans
    return []


def trace_device_spans(fn, *args) -> Spans:
    """The ``(start, end)`` microseconds of the device records of one
    ``torch.profiler`` window around ``fn(*args)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def measure_device_time(fn, *args) -> Optional[float]:
    """Run ``fn(*args)`` inside a ``torch.profiler`` window and return the
    seconds the card was busy with it, or None without a card or when
    ``TRACE_ATTEMPTS`` windows held no device work."""
    if not torch.cuda.is_available():
        return None
    spans = first_busy(lambda: trace_device_spans(fn, *args))
    return busy_seconds(spans) / 1e6 if spans else None


def card(device=None) -> dict:
    """The device a result was measured on: for a CUDA device, its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (a card may be set below its
    maximum, and then runs slower under load); ``{"name": "cpu"}`` else."""
    dev = torch.device(device if device is not None
                       else ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    import subprocess

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={index}"], capture_output=True, text=True, check=True)
    name, _, limit = smi.stdout.strip().rpartition(", ")
    return {"name": name, "power_limit": limit, "nvidia_smi": smi.stdout.strip()}


def main(argv=None) -> int:
    """Count, over ``--windows`` searches of 100 queries on brute force over
    10,000 x 128 rows, the single windows without device records and the
    calls of :func:`measure_device_time` that return None."""
    import argparse
    import json

    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import brute_force

    ap = argparse.ArgumentParser(prog="python -m raft_tpu_torch.bench.device_time")
    ap.add_argument("--windows", type=int, default=1000)
    args = ap.parse_args(argv)
    res = Resources()
    gen = torch.Generator(device=res.device).manual_seed(0)
    index = brute_force.build(torch.randn(10_000, 128, device=res.device, generator=gen),
                              res=res)
    q = torch.randn(100, 128, device=res.device, generator=gen)

    def search():
        return brute_force.search(index, q, 10, res=res)

    search()
    lost = sum(busy_seconds(trace_device_spans(search)) == 0 for _ in range(args.windows))
    none = sum(measure_device_time(search) is None for _ in range(args.windows))
    print(json.dumps({"windows": args.windows, "windows_without_device_records": lost,
                      "calls_without_device_time": none, "attempts": TRACE_ATTEMPTS,
                      "device": card(res.device)}), flush=True)
    return 0 if none == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
