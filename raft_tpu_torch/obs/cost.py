"""Capacity accounting of one call: the work its kernels do, its time on
the card, and its share of the roofline (counterpart of
``raft_tpu.obs.cost``).

raft_tpu asks XLA's cost model of an AOT-compiled executable for its FLOPs
and bytes.  The port has no compiler to ask: every kernel wrapper notes
the work of its launch (``ops.cost.note``: each input byte read once, each
output written once, the operations of the function, real rows only), and
:func:`analyze_callable` sums the notes of one call of the function
(``ops.cost.capture``), times a second call with CUDA events (the host
clock on the CPU), reads the card's peak memory over it, and takes the
roofline share against the H100's peaks (``ops.cost``: each note's
operations at the peak of its arithmetic, the bytes at the memory rate;
``RAFT_TPU_PEAK_FLOPS`` / ``RAFT_TPU_PEAK_BW`` override the peaks).
Whatever is absent stays absent: a call whose work ran on no kernel (a CPU
call, plain PyTorch ops) notes nothing and publishes no work gauge.

:func:`refresh_live_buffer_gauges` / :func:`refresh_page_gauges` publish
per-version memory gauges from any object with ``live_versions()`` (the
serving layer's ``IndexRegistry``); :func:`refresh_mutation_gauges` the
per-index mutation pressure of its current entries.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.logger import child as _child_logger
from raft_tpu_torch.obs.registry import MetricsRegistry, default_registry
from raft_tpu_torch.ops import cost as ops_cost

_log = _child_logger("obs.cost")

#: (peak FLOP/s, peak memory bandwidth bytes/s) per platform family: the
#: H100 SXM's f32 rate and HBM3 rate (``ops.cost``), and raft_tpu's round
#: CPU estimate.  Override with RAFT_TPU_PEAK_FLOPS / RAFT_TPU_PEAK_BW.
DEFAULT_PEAKS: Dict[str, Tuple[float, float]] = {
    "gpu": (ops_cost.H100_F32_FLOPS, ops_cost.H100_BYTES_PER_S),
    "cpu": (1e11, 5e10),
}


def _platform(platform: Optional[str] = None) -> str:
    if platform is not None:
        return platform
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def device_peaks(platform: Optional[str] = None) -> Tuple[float, float]:
    """(peak_flops_per_s, peak_bytes_per_s) for the platform ("gpu" when a
    card is present, else "cpu")."""
    flops, bw = DEFAULT_PEAKS.get(_platform(platform), DEFAULT_PEAKS["cpu"])
    flops = _env.env_float("RAFT_TPU_PEAK_FLOPS", flops)
    bw = _env.env_float("RAFT_TPU_PEAK_BW", bw)
    return flops, bw


@dataclass
class CostReport:
    """Everything measured of one call (None = not known)."""

    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    peak_memory_bytes: Optional[float] = None
    argument_memory_bytes: Optional[float] = None
    output_memory_bytes: Optional[float] = None
    seconds: Optional[float] = None          # one timed call
    utilization: Optional[float] = None      # bound time / measured time
    launches: Optional[int] = None           # kernel launches that noted their work
    labels: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {k: v for k, v in vars(self).items() if v is not None}


def roofline_share(notes, seconds: Optional[float],
                   platform: Optional[str] = None) -> Optional[float]:
    """The least time the noted work could take (the larger of its
    operations at the peak of each note's arithmetic and its bytes at the
    memory rate) over the measured ``seconds``; None without notes or time.
    On the card the kernels run one after another, so this is at most 1."""
    if not notes or not seconds or seconds <= 0:
        return None
    platform = _platform(platform)
    flops_env = _env.env_float("RAFT_TPU_PEAK_FLOPS", None)
    _, bw = device_peaks(platform)
    if flops_env is not None or platform != "gpu":
        peak = device_peaks(platform)[0]
        peaks = {kind: peak for kind in ops_cost.H100_PEAK_OPS}
    else:
        peaks = ops_cost.H100_PEAK_OPS
    t_ops = ops_cost.ops_seconds(notes, peaks)
    t_bytes = sum(c.bytes_accessed for _, c in notes) / bw
    return float(max(t_ops, t_bytes) / seconds)


def roofline_utilization(
    flops: Optional[float],
    bytes_accessed: Optional[float],
    seconds: Optional[float],
    platform: Optional[str] = None,
) -> Optional[float]:
    """Achieved FLOP/s as a fraction of the roofline-attainable rate
    ``min(peak_flops, intensity * peak_bw)`` (raft_tpu's
    ``roofline_utilization``; the perf ledger's measured share of a
    dispatch's noted work).  None when any input is unknown."""
    if not flops or not seconds or seconds <= 0:
        return None
    peak_flops, peak_bw = device_peaks(platform)
    attainable = peak_flops
    if bytes_accessed and bytes_accessed > 0:
        attainable = min(peak_flops, (flops / bytes_accessed) * peak_bw)
    if attainable <= 0:
        return None
    return float((flops / seconds) / attainable)


def _tensor_bytes(obj) -> int:
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(o) for o in obj)
    return 0


def _cuda_of(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.device if obj.device.type == "cuda" else None
    if isinstance(obj, (tuple, list)):
        for o in obj:
            dev = _cuda_of(o)
            if dev is not None:
                return dev
    return None


def analyze_callable(fn, *args, time_run: bool = True) -> Optional[CostReport]:
    """Call ``fn(*args)`` once inside an ``ops.cost.capture`` scope and sum
    the work its kernels noted; with ``time_run`` call it again outside the
    scope (the notes' device reads would stretch the time) and time that
    call (CUDA events around it where an argument or the output is on the
    card, the host clock otherwise), with the card's peak memory over it.
    Returns None when the call raises.  Calls ``fn`` twice: not for a
    request path."""
    import torch

    try:
        with ops_cost.capture() as notes:
            out = fn(*args)
        dev = _cuda_of(out) or _cuda_of(args)
        if dev is not None:
            torch.cuda.synchronize(dev)
    except Exception as exc:
        _log.debug("cost analysis unavailable: %r", exc)
        return None
    rep = CostReport(launches=len(notes))
    total = ops_cost.noted_total(notes)
    if total is not None:
        rep.flops = float(total.flops)
        rep.bytes_accessed = float(total.bytes_accessed)
    rep.argument_memory_bytes = float(_tensor_bytes(args)) or None
    rep.output_memory_bytes = float(_tensor_bytes(out)) or None
    del out
    if time_run:
        if dev is not None:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize(dev)
            rep.seconds = start.elapsed_time(end) / 1e3
            rep.peak_memory_bytes = float(torch.cuda.max_memory_allocated(dev))
        else:
            t0 = time.perf_counter()
            fn(*args)
            rep.seconds = time.perf_counter() - t0
    rep.utilization = roofline_share(notes, rep.seconds, "gpu" if dev is not None else "cpu")
    return rep


#: gauge name → CostReport attribute published by record_cost (raft_tpu's
#: ``raft_tpu_xla_*`` gauges; the work comes from the kernels' notes here)
_GAUGES = (
    ("raft_tpu_kernel_flops", "flops",
     "operations one call's kernels need (their noted work)"),
    ("raft_tpu_kernel_bytes_accessed", "bytes_accessed",
     "bytes one call's kernels must move (their noted work)"),
    ("raft_tpu_peak_memory_bytes", "peak_memory_bytes",
     "peak device memory allocated over one call"),
    ("raft_tpu_argument_memory_bytes", "argument_memory_bytes",
     "tensor argument bytes of one call"),
    ("raft_tpu_output_memory_bytes", "output_memory_bytes",
     "tensor output bytes of one call"),
    ("raft_tpu_roofline_utilization", "utilization",
     "least time the noted work could take over the measured time (0..1)"),
)


def record_cost(
    report: Optional[CostReport],
    registry: Optional[MetricsRegistry] = None,
    **labels: str,
) -> None:
    """Publish a report's known fields as gauges; absent fields publish
    nothing."""
    if report is None:
        return
    reg = registry if registry is not None else default_registry()
    report.labels = {str(k): str(v) for k, v in labels.items()}
    for gauge_name, attr, help_ in _GAUGES:
        val = getattr(report, attr)
        if val is not None:
            reg.gauge(gauge_name, help=help_).set(float(val), **labels)


# ---------------------------------------------------------------------------
# per-version memory gauges

def refresh_live_buffer_gauges(
    index_registry, registry: Optional[MetricsRegistry] = None,
) -> Dict[str, float]:
    """Publish ``raft_tpu_index_live_bytes{index=,version=}`` for every
    index version still alive (``index_registry.live_versions()`` maps
    ``(name, version)`` to an object with ``device_bytes()``; paged
    versions report through :func:`refresh_page_gauges`).  A version the
    GC collected gets its series removed, so a series that never goes away
    is a leak.
    """
    reg = registry if registry is not None else default_registry()
    gauge = reg.gauge(
        "raft_tpu_index_live_bytes",
        help="host+device bytes held by each still-reachable index version",
    )
    live: Dict[str, float] = {}
    alive_keys = set()
    for (name, version), index in index_registry.live_versions().items():
        if getattr(getattr(index, "index", None), "paged", None) is not None:
            # paged versions report through the page-residency gauges
            # (refresh_page_gauges) — a monolithic live-bytes series for
            # them would double-count the aliased cold tier; any series a
            # version published before pagination retires below
            continue
        try:
            nbytes = float(index.device_bytes())
        except Exception:
            continue
        labels = {"index": name, "version": str(version)}
        gauge.set(nbytes, **labels)
        alive_keys.add((name, str(version)))
        live[f"{name}:v{version}"] = nbytes
    # retire series whose version object is gone
    for key in gauge.series():
        d = dict(key)
        if "index" in d and "version" in d:
            if (d["index"], d["version"]) not in alive_keys:
                gauge.remove(**d)
    return live


def refresh_page_gauges(
    index_registry, registry: Optional[MetricsRegistry] = None,
) -> Dict[str, Dict[str, float]]:
    """Publish page-residency gauges for every still-reachable *paged*
    index version: ``raft_tpu_page_resident{index=,version=}`` (pages in
    the HBM hot pool), ``raft_tpu_page_host`` (cold pages on host only),
    and ``raft_tpu_page_pool_bytes`` (device bytes the hot pool + page
    table reserve from the memory budget).

    Rides the same weak version history as
    :func:`refresh_live_buffer_gauges` and retires series whose version
    object the GC collected — the fetch/eviction *flow* counters
    (``raft_tpu_page_{hits,misses,evictions}_total``) are push-side,
    bumped by :class:`~raft_tpu_torch.store.tiered.TieredStore` itself.
    """
    reg = registry if registry is not None else default_registry()
    g_res = reg.gauge(
        "raft_tpu_page_resident",
        help="HBM-resident pages of each still-reachable paged index version",
    )
    g_host = reg.gauge(
        "raft_tpu_page_host",
        help="host-only (cold) pages of each still-reachable paged index version",
    )
    g_bytes = reg.gauge(
        "raft_tpu_page_pool_bytes",
        help="device bytes reserved by each paged version's hot pool",
    )
    out: Dict[str, Dict[str, float]] = {}
    alive = set()
    for (name, version), index in index_registry.live_versions().items():
        tiered = getattr(getattr(index, "index", None), "paged", None)
        if tiered is None:
            continue
        try:
            st = tiered.stats()
            pool_bytes = float(tiered.nbytes)
        except Exception:
            continue
        labels = {"index": name, "version": str(version)}
        g_res.set(float(st["resident"]), **labels)
        g_host.set(float(st["host_only"]), **labels)
        g_bytes.set(pool_bytes, **labels)
        alive.add((name, str(version)))
        out[f"{name}:v{version}"] = {
            "resident": float(st["resident"]),
            "host": float(st["host_only"]),
            "pool_bytes": pool_bytes,
        }
    for gauge in (g_res, g_host, g_bytes):
        for key in gauge.series():
            d = dict(key)
            if "index" in d and "version" in d:
                if (d["index"], d["version"]) not in alive:
                    gauge.remove(**d)
    return out


def refresh_mutation_gauges(
    index_registry, registry: Optional[MetricsRegistry] = None,
) -> Dict[str, Dict[str, float]]:
    """Publish per-index mutation-pressure gauges from the registry's
    *current* entries: ``raft_tpu_index_pending_deletes``,
    ``raft_tpu_index_side_rows``, and ``raft_tpu_index_tombstone_frac``
    (tombstones over main rows, construction padding excluded).

    These are the compaction trigger inputs — the same numbers
    :class:`~raft_tpu_torch.serve.compactor.Compactor` compares against its
    policy — so compaction pressure is visible in ``prometheus()``
    output, not only via method calls.  Entries that are not
    :class:`~raft_tpu_torch.serve.mutation.MutableIndex` (sharded indexes,
    raw wrappers without a side buffer) are skipped; series for names
    no longer registered are removed, mirroring
    :func:`refresh_live_buffer_gauges`.
    """
    reg = registry if registry is not None else default_registry()
    g_del = reg.gauge(
        "raft_tpu_index_pending_deletes",
        help="tombstoned rows awaiting compaction (padding excluded)",
    )
    g_side = reg.gauge(
        "raft_tpu_index_side_rows",
        help="live upsert rows in the brute-force side buffer",
    )
    g_frac = reg.gauge(
        "raft_tpu_index_tombstone_frac",
        help="pending deletes over main structure rows",
    )
    out: Dict[str, Dict[str, float]] = {}
    alive = set()
    for name in index_registry.names():
        try:
            index = index_registry.get(name)
            deletes, side = index.pending_mutations()
            denom = max(
                index.main_size - getattr(index, "_n_structural", 0), 1
            )
        except (KeyError, AttributeError):
            continue
        except Exception:
            continue
        frac = float(deletes) / float(denom)
        g_del.set(deletes, index=name)
        g_side.set(side, index=name)
        g_frac.set(frac, index=name)
        alive.add(name)
        out[name] = {
            "pending_deletes": float(deletes),
            "side_rows": float(side),
            "tombstone_frac": frac,
        }
    for gauge in (g_del, g_side, g_frac):
        for key in gauge.series():
            d = dict(key)
            if d.get("index") not in alive:
                gauge.remove(**d)
    return out
