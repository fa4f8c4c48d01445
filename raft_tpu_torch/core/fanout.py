"""Batch fan-out: dispatch everything, synchronise once (counterpart of
``raft_tpu.core.fanout``; the reference's stream-pool fan-out,
``cuda_stream_pool.hpp``).

CUDA launches are asynchronous: a call that only enqueues kernels returns
at once, so consecutive independent calls run back to back on the card
while the host prepares the next.  :func:`async_fanout` makes that idiom a
component; :func:`prefetch_to_device` overlaps host-to-device copies of
the next chunks with the consumer's work on a side stream.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import default_resources, from_numpy


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in a nest of tuples, lists and dicts."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    return found


def async_fanout(fn: Callable, arg_tuples: Sequence[Tuple]) -> List:
    """Call ``fn(*args)`` for every tuple without waiting between calls,
    then wait once for the devices the outputs live on: every call's work
    is in flight together."""
    outs = [fn(*args) for args in arg_tuples]
    for dev in _cuda_devices(outs, set()):
        torch.cuda.synchronize(dev)
    return outs


def row_batches(x, batch_rows: int) -> Iterator:
    """Slices of a [n, ...] array into row batches of at most ``batch_rows``."""
    n = x.shape[0]
    for s in range(0, n, batch_rows):
        yield x[s:min(s + batch_rows, n)]


def prefetch_to_device(chunks: Iterable, lookahead: int = 2, *, device=None) -> Iterator:
    """Yield each host chunk (numpy or tensor) as a tensor on ``device``
    (default: the default Resources' device, cuda), keeping ``lookahead``
    chunks' copies in flight ahead of the consumer.

    On the card each chunk is staged in pinned host memory and copied with
    ``non_blocking=True`` on a side stream; the consumer's stream waits on
    that copy's event before the chunk is yielded, and the chunk is marked
    used on the consumer's stream (``record_stream``), so the caching
    allocator never hands its memory out while the consumer's work on it
    is queued.  On the CPU the chunks pass through."""
    device = torch.device(device) if device is not None else default_resources().device
    it = iter(chunks)
    if device.type != "cuda":
        for chunk in it:
            yield (from_numpy(chunk) if isinstance(chunk, np.ndarray) else chunk).to(device)
        return
    side = torch.cuda.Stream(device=device)
    queue: collections.deque = collections.deque()

    def stage(chunk):
        host = from_numpy(chunk) if isinstance(chunk, np.ndarray) else chunk
        if host.device.type == "cpu" and not host.is_pinned():
            host = host.pin_memory()
        with torch.cuda.stream(side):
            out = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        # the pinned buffer stays referenced until its copy's event is waited on
        queue.append((out, done, host))

    def hand_over():
        out, done, _ = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        out.record_stream(consumer)
        return out

    for chunk in it:
        stage(chunk)
        if len(queue) > lookahead:
            yield hand_over()
    while queue:
        yield hand_over()
