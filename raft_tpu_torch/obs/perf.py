"""Measured perf ledger: device time by executable key (counterpart of
``raft_tpu.obs.perf``).

Every dispatched batch lands one :meth:`PerfLedger.record` keyed by
``(index, backend, bucket, kernel_path, version)``, accumulating device
seconds, dispatches, rows and pad waste.  ``kernel_path`` is what the
search stamped (``kernels.stamp_kernel_path``): "cuda" where a tensor on
the card went to the kernels, "torch" where the plain versions ran.
:meth:`PerfLedger.top_hotspots` ranks keys by device seconds with a
measured roofline utilization (the work warmup noted per dispatch over the
measured seconds, against ``obs.cost.device_peaks``), and a per-key EWMA
pair (fast vs slow baseline) publishes a ``perf_regression`` bus event
when the fast EWMA exceeds ``RAFT_TPU_PERF_REGRESSION_X`` times the
baseline, debounced per key; the bus turns that into a flight dump, a
:mod:`raft_tpu_torch.obs.profiler` capture and a correlated incident.

``record`` takes the batcher's existing device-stage time: no clock runs
here.  Knobs: ``RAFT_TPU_PERF_LEDGER`` (default on),
``RAFT_TPU_PERF_EWMA_ALPHA``, ``RAFT_TPU_PERF_REGRESSION_X``,
``RAFT_TPU_PERF_MIN_SAMPLES``, ``RAFT_TPU_PERF_DEBOUNCE_S``,
``RAFT_TPU_PERF_CAPTURE_S``, ``RAFT_TPU_PERF_CAPTURE_DIR``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.obs import cost as _cost
from raft_tpu_torch.obs.registry import default_registry

#: executable key: (index, backend, bucket, kernel_path, version)
Key = Tuple[str, str, int, str, str]

#: slow-baseline EWMA weight as a fraction of the fast weight — the
#: baseline must move an order of magnitude slower than the detector or
#: a sustained regression drags the baseline up and clears itself
_SLOW_DIV = 8.0


def enabled() -> bool:
    """Master switch (``RAFT_TPU_PERF_LEDGER``).  The batcher samples it
    once at construction so a disabled ledger costs zero per dispatch."""
    return _env.env_bool("RAFT_TPU_PERF_LEDGER", True)


def _env_alpha() -> float:
    try:
        a = _env.env_float("RAFT_TPU_PERF_EWMA_ALPHA", 0.25)
    except ValueError:
        a = 0.25
    return min(max(a, 1e-3), 1.0)


def _env_regression_x() -> float:
    try:
        return max(1.0, _env.env_float("RAFT_TPU_PERF_REGRESSION_X", 1.5))
    except ValueError:
        return 1.5


def _env_min_samples() -> int:
    try:
        return max(1, _env.env_int("RAFT_TPU_PERF_MIN_SAMPLES", 32))
    except ValueError:
        return 32


def _env_debounce_s() -> float:
    try:
        return max(0.0, _env.env_float("RAFT_TPU_PERF_DEBOUNCE_S", 60.0))
    except ValueError:
        return 60.0


class _KeyStats:
    """Accumulated measurements for one executable key."""

    __slots__ = (
        "device_s", "dispatches", "rows", "padded_rows",
        "fast", "slow", "samples", "last_fire_m", "regressions",
    )

    def __init__(self) -> None:
        self.device_s = 0.0
        self.dispatches = 0
        self.rows = 0
        self.padded_rows = 0
        self.fast: Optional[float] = None   # fast device-time EWMA (s)
        self.slow: Optional[float] = None   # slow baseline EWMA (s)
        self.samples = 0
        self.last_fire_m = float("-inf")    # time.monotonic of last event
        self.regressions = 0


class PerfLedger:
    """Measured device-time accounting per executable key.

    One instance normally lives for the process (:func:`default_ledger`);
    tests build private ones.  All methods are thread-safe — the batcher
    worker records, completion threads record (pipelined path), any
    thread snapshots.
    """

    def __init__(
        self,
        *,
        alpha: Optional[float] = None,
        regression_x: Optional[float] = None,
        min_samples: Optional[int] = None,
        debounce_s: Optional[float] = None,
    ):
        self._lock = threading.Lock()
        self._keys: Dict[Key, _KeyStats] = {}
        # analytical per-dispatch cost, keyed (index, bucket): the shapes
        # (hence FLOPs/bytes) are identical across kernel_path/version
        self._costs: Dict[Tuple[str, int], Tuple[float, float]] = {}
        self._alpha = alpha if alpha is not None else _env_alpha()
        self._regression_x = (
            regression_x if regression_x is not None else _env_regression_x()
        )
        self._min_samples = (
            min_samples if min_samples is not None else _env_min_samples()
        )
        self._debounce_s = (
            debounce_s if debounce_s is not None else _env_debounce_s()
        )

    # -- recording ----------------------------------------------------------
    def register_cost(self, index: str, bucket: int, flops: float,
                      bytes_accessed: float) -> None:
        """Attach the analytical per-dispatch cost of one ``(index,
        bucket)`` executable (the batcher's warmup cost accounting calls
        this) so hotspots can report measured FLOP/s, bytes/s and
        roofline utilization."""
        with self._lock:
            self._costs[(str(index), int(bucket))] = (
                float(flops), float(bytes_accessed)
            )

    @traced("perf.record")
    def record(
        self,
        *,
        index: str,
        backend: str,
        bucket: int,
        kernel_path: str,
        version: str,
        device_s: float,
        rows: int,
        padded_rows: int,
    ) -> None:
        """Account one dispatched batch.  ``device_s`` is the batcher's
        existing device-stage measurement — no clock runs here."""
        key: Key = (
            str(index), str(backend), int(bucket), str(kernel_path),
            str(version),
        )
        device_s = float(device_s)
        tripped = False
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                st = self._keys[key] = _KeyStats()
            st.device_s += device_s
            st.dispatches += 1
            st.rows += int(rows)
            st.padded_rows += int(padded_rows)
            st.samples += 1
            if st.fast is None:
                st.fast = st.slow = device_s
            else:
                a = self._alpha
                st.fast += a * (device_s - st.fast)
                # the baseline learns at the detector rate until the key
                # arms, then freezes to the slow rate: a warmup transient
                # (short pipeline-fill samples) must converge into the
                # baseline before the trip check goes live, or every
                # steady workload alarms at its arming sample
                b = a if st.samples < self._min_samples else a / _SLOW_DIV
                st.slow += b * (device_s - st.slow)
            # inline trip pre-check: pure float math, evaluate() (the
            # debounce + publish) runs only for keys that actually trip
            tripped = (
                st.samples >= self._min_samples
                and st.slow is not None
                and st.slow > 0.0
                and st.fast > self._regression_x * st.slow
            )
        reg = default_registry()
        labels = {
            "index": key[0], "backend": key[1], "bucket": str(key[2]),
            "kernel_path": key[3], "version": key[4],
        }
        reg.counter(
            "raft_tpu_perf_device_seconds_total",
            help="measured device seconds per executable key",
        ).inc(device_s, **labels)
        reg.counter(
            "raft_tpu_perf_dispatches_total",
            help="dispatched batches per executable key",
        ).inc(**labels)
        reg.counter(
            "raft_tpu_perf_rows_total",
            help="real rows served per executable key",
        ).inc(int(rows), **labels)
        if tripped:
            self.evaluate(key)

    @traced("perf.evaluate")
    def evaluate(self, key: Key) -> bool:
        """Debounce-check a tripped key and publish ``perf_regression``.

        Returns True when the event was published (once per
        ``RAFT_TPU_PERF_DEBOUNCE_S`` window per key); suppressed trips
        are counted, never silently dropped."""
        now = time.monotonic()
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                return False
            if now - st.last_fire_m < self._debounce_s:
                suppressed = True
            else:
                st.last_fire_m = now
                st.regressions += 1
                suppressed = False
            fast, slow = st.fast, st.slow
        index, backend, bucket, kernel_path, version = key
        if suppressed:
            default_registry().counter(
                "raft_tpu_perf_regressions_suppressed_total",
                help="regression trips suppressed by the per-key debounce",
            ).inc(index=index, bucket=str(bucket))
            return False
        ratio = (fast / slow) if slow else float("inf")
        from raft_tpu_torch.obs import events as _events

        _events.publish(
            "perf_regression", f"perf_regression_{index}",
            index=index, backend=backend, bucket=bucket,
            kernel_path=kernel_path, version=version,
            fast_ms=fast * 1e3, baseline_ms=slow * 1e3,
            ratio=ratio,
        )
        return True

    # -- reading ------------------------------------------------------------
    def top_hotspots(self, n: int = 8) -> List[Dict[str, object]]:
        """Keys ranked by cumulative device seconds, with measured
        throughput and roofline utilization where warmup registered the
        analytical cost.  ``wasted_frac`` is the pad-waste-derived share
        of device time spent on rows nobody asked for (padding rows run
        at the same per-row cost as real ones inside a fixed-shape
        executable)."""
        with self._lock:
            items = [(k, st) for k, st in self._keys.items()]
            costs = dict(self._costs)
        items.sort(key=lambda kv: kv[1].device_s, reverse=True)
        out: List[Dict[str, object]] = []
        for key, st in items[: max(0, int(n))]:
            index, backend, bucket, kernel_path, version = key
            entry: Dict[str, object] = {
                "index": index,
                "backend": backend,
                "bucket": bucket,
                "kernel_path": kernel_path,
                "version": version,
                "device_s": st.device_s,
                "dispatches": st.dispatches,
                "rows": st.rows,
                "padded_rows": st.padded_rows,
                "wasted_frac": (
                    1.0 - st.rows / st.padded_rows
                    if st.padded_rows else None
                ),
                "regressions": st.regressions,
            }
            cost = costs.get((index, bucket))
            if cost is not None and st.device_s > 0:
                flops, nbytes = cost
                entry["flops_per_s"] = flops * st.dispatches / st.device_s
                entry["bytes_per_s"] = nbytes * st.dispatches / st.device_s
                entry["roofline_utilization"] = _cost.roofline_utilization(
                    flops * st.dispatches, nbytes * st.dispatches,
                    st.device_s,
                )
            out.append(entry)
        return out

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per-index device-second totals (reconciliation surface for
        tests: sums over keys must match the metrics device-stage
        totals)."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for (index, _b, _bk, _kp, _v), st in self._keys.items():
                agg = out.setdefault(
                    index, {"device_s": 0.0, "dispatches": 0, "rows": 0}
                )
                agg["device_s"] += st.device_s
                agg["dispatches"] += st.dispatches
                agg["rows"] += st.rows
        return out

    def refresh_gauges(self) -> None:
        """Publish the derived per-key gauges (wasted fraction, roofline
        utilization).  Pull-path work — called from :meth:`snapshot` and
        the service scrape endpoints, never per dispatch."""
        reg = default_registry()
        for h in self.top_hotspots(n=len(self._keys)):
            labels = {
                "index": h["index"], "backend": h["backend"],
                "bucket": str(h["bucket"]),
                "kernel_path": h["kernel_path"],
                "version": h["version"],
            }
            if h["wasted_frac"] is not None:
                reg.gauge(
                    "raft_tpu_perf_wasted_frac",
                    help="fraction of device time spent on padding rows",
                ).set(float(h["wasted_frac"]), **labels)
            util = h.get("roofline_utilization")
            if util is not None:
                reg.gauge(
                    "raft_tpu_perf_roofline_utilization",
                    help="measured FLOP/s over the roofline-attainable "
                         "rate per executable key",
                ).set(float(util), **labels)

    def health_slice(self) -> Dict[str, object]:
        """The slice :func:`raft_tpu_torch.obs.health.perf_check` folds into
        the health report: keys whose regression fired within the
        current debounce window (i.e. an un-cleared regression)."""
        now = time.monotonic()
        active = []
        with self._lock:
            for key, st in self._keys.items():
                if now - st.last_fire_m < self._debounce_s:
                    index, _backend, bucket, kernel_path, _v = key
                    active.append(f"{index}/b{bucket}/{kernel_path}")
        return {"active_regressions": sorted(active)}

    def snapshot(self) -> Dict[str, object]:
        """Provider section for ``obs.snapshot()["perf"]`` (JSON-safe)."""
        self.refresh_gauges()
        with self._lock:
            n_keys = len(self._keys)
            total_device_s = sum(st.device_s for st in self._keys.values())
            total_dispatches = sum(
                st.dispatches for st in self._keys.values()
            )
            regressions = sum(st.regressions for st in self._keys.values())
        return {
            "enabled": enabled(),
            "keys": n_keys,
            "device_s": total_device_s,
            "dispatches": total_dispatches,
            "regressions": regressions,
            "hotspots": self.top_hotspots(),
            **self.health_slice(),
        }


# ---------------------------------------------------------------------------
# the process-wide default ledger + bus wiring

_default_lock = threading.Lock()
_default: Optional[PerfLedger] = None


def default_ledger() -> PerfLedger:
    """The process-wide ledger (created against current env knobs)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = PerfLedger()
        return _default


def ledger_snapshot() -> Dict[str, object]:
    """Provider section for registry snapshots."""
    return default_ledger().snapshot()


def _capture_dir() -> str:
    d = _env.env_str("RAFT_TPU_PERF_CAPTURE_DIR")
    if d:
        return d
    from raft_tpu_torch.obs import flight as _flight

    return _flight._env_dir()


def _on_bus_event(event) -> None:
    """``perf_regression`` subscriber: kick a debounced async profiler
    capture.  Installed between the flight dumper and the incident
    manager, so by the time the incident manager handles the same event
    both the flight dump *and* the capture are fresh enough to attach."""
    if event.recovered:
        return
    try:
        capture_s = _env.env_float("RAFT_TPU_PERF_CAPTURE_S", 1.0)
    except ValueError:
        capture_s = 1.0
    if capture_s <= 0:
        return
    from raft_tpu_torch.obs import profiler as _profiler

    _profiler.capture_async(
        _capture_dir(), duration_s=capture_s, reason=event.reason,
    )


def install_bus_subscriber(bus) -> None:
    """Wire the regression→capture hook into ``bus`` (called by
    ``events._install_default_subscribers``)."""
    bus.subscribe(
        _on_bus_event,
        kinds=frozenset({"perf_regression"}),
        name="perf_capture",
    )


def _on_bus_reset() -> None:
    """Drop the default ledger (test/REPL hygiene — the next
    :func:`default_ledger` re-reads the env knobs)."""
    global _default
    import sys

    with _default_lock:
        _default = None
    profiler = sys.modules.get("raft_tpu_torch.obs.profiler")
    if profiler is not None:
        profiler.reset()
