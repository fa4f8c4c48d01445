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

The card's tracer now and then returns a window with no device record at
all, and sometimes one that lost only some of them: a busy time read from
it would be short, a wrong number rather than a noisy one.  So each window
is held to the port's own launches over it: the launches counted in it
(``kernels.launch_counts()``, read before and after the call) against the
device records carrying each launch's kernel name
(``kernels.trace_name``).  A window with no device record, or with fewer
records of a kernel than launches of it, is taken again; after
``TRACE_ATTEMPTS`` such windows the counter is None, which the runner and
the ladder report as a missing value.  ``python -m
raft_tpu_torch.bench.device_time`` counts, on the card, the windows that
lost all or some records and the calls that still come back without device
time.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

#: windows of one call taken before it counts as without device time: a
#: window that lost device records is followed, now and then, by another
#: that lost them too
TRACE_ATTEMPTS = 4

#: device records of a window: ``(start, end)`` or ``(start, end, name)``
Spans = List[Tuple]


def busy_seconds(intervals: Iterable[Tuple]) -> float:
    """Length of the union of ``(start, end[, name])`` intervals (same unit
    in and out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e, *_ in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def first_busy(trace: Callable[[], Spans], attempts: int = TRACE_ATTEMPTS,
               whole: Callable[[Spans], bool] = lambda spans: True) -> Spans:
    """The spans of the first of up to ``attempts`` calls of ``trace()``
    whose union is not empty and that ``whole(spans)`` accepts, else
    ``[]``."""
    for _ in range(attempts):
        spans = trace()
        if busy_seconds(spans) > 0 and whole(spans):
            return spans
    return []


def missing_records(spans: Spans, launched: Dict[str, int]) -> int:
    """Launches of ``launched`` (launch name → count) that have no device
    record of their kernel's name among ``spans`` (``(start, end, name)``)."""
    from raft_tpu_torch.kernels import trace_name

    want: Dict[str, int] = {}
    for launch, n in launched.items():
        if n:
            key = trace_name(launch)
            want[key] = want.get(key, 0) + n
    names = [rec[2] for rec in spans if len(rec) > 2]
    return sum(max(0, n - sum(key in name for name in names)) for key, n in want.items())


def is_device_work(event) -> bool:
    """Whether a ``torch.profiler`` event is work the card did (a kernel, a
    copy, a fill): a device event that is not a user annotation.  The
    port's ``core.trace`` ranges (``raft_tpu.<label>``) show on the device
    timeline as annotations spanning every launch of their call, gaps
    included."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False)
            and not event.name.startswith("raft_tpu."))


def trace_device_spans(fn, *args) -> Tuple[Spans, Dict[str, int]]:
    """The ``(start, end, name)`` records (microseconds) of the device work
    of one ``torch.profiler`` window around ``fn(*args)``, and the port's
    kernel launches made in it (launch name → count)."""
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.kernels import launch_counts

    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    after = launch_counts()
    launched = {name: after[name] - before[name] for name in after if after[name] > before[name]}
    return ([(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if is_device_work(e)], launched)


def measure_device_time(fn, *args) -> Optional[float]:
    """Run ``fn(*args)`` inside a ``torch.profiler`` window and return the
    seconds the card was busy with it, or None without a card or when
    ``TRACE_ATTEMPTS`` windows held no device work or fewer records of the
    port's kernels than it launched."""
    if not torch.cuda.is_available():
        return None
    launched: Dict[str, int] = {}

    def trace():
        spans, got = trace_device_spans(fn, *args)
        launched.clear()
        launched.update(got)
        return spans

    spans = first_busy(trace, whole=lambda s: missing_records(s, launched) == 0)
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
    10,000 x 128 rows, the single windows without device records, those
    that lost some of the port's kernel records, and the calls of
    :func:`measure_device_time` that return None."""
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
    lost = partial = 0
    for _ in range(args.windows):
        spans, launched = trace_device_spans(search)
        if busy_seconds(spans) == 0:
            lost += 1
        elif missing_records(spans, launched):
            partial += 1
    none = sum(measure_device_time(search) is None for _ in range(args.windows))
    print(json.dumps({"windows": args.windows, "windows_without_device_records": lost,
                      "windows_missing_kernel_records": partial,
                      "calls_without_device_time": none, "attempts": TRACE_ATTEMPTS,
                      "device": card(res.device)}), flush=True)
    return 0 if none == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
