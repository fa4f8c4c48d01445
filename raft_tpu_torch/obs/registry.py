"""Process-wide metrics registry: counters, gauges, labeled histograms
(counterpart of ``raft_tpu.obs.registry``, copied with its metric
semantics, bucket ladder and reservoir so that both packages export the
same text for the same operations).

- **Thread-safe**: one lock per registry guards the metric map; each series
  updates under it.  Recording is a dict lookup + float add.
- **Fixed bucket ladders**: histograms bucket into a ladder fixed at
  creation (default: exponential seconds ladder spanning 50 µs → 60 s), so
  the Prometheus export is a classic cumulative ``_bucket`` series.  A
  bounded reservoir of raw observations rides along for exact percentiles
  in JSON snapshots.
- **Label-cardinality cap**: every metric refuses to materialize more than
  ``max_series`` distinct label sets — a runaway label (e.g. a request id)
  raises :class:`LabelCardinalityError` instead of silently leaking memory.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: default per-metric cap on distinct label sets
MAX_SERIES = 256

#: default histogram ladder: exponential, 50 µs .. 60 s (seconds).  Chosen
#: to straddle both single small-batch searches (~100 µs) and cold kernel
#: builds (tens of seconds; longer tails land in +Inf).
DEFAULT_BUCKETS = tuple(
    5e-5 * (2.0 ** i) for i in range(21)
)  # 50us, 100us, ... ~52s

#: bounded per-series reservoir for exact percentile math
_RESERVOIR = 2048

LabelValue = Tuple[Tuple[str, str], ...]


class LabelCardinalityError(RuntimeError):
    """A metric exceeded its label-set cap (would leak memory forever)."""


def _label_key(labels: Dict[str, str]) -> LabelValue:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Base: named metric holding labeled series under the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 max_series: int):
        self.name = name
        self.help = help
        self._lock = lock
        self._max_series = max_series
        self._series: Dict[LabelValue, object] = {}

    def _get_series(self, labels: Dict[str, str]):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self._max_series:
                raise LabelCardinalityError(
                    f"metric {self.name!r} exceeded {self._max_series} label "
                    f"sets (offending labels: {dict(key)!r}); a label is "
                    "probably carrying an unbounded value (request id, "
                    "timestamp, ...)"
                )
            s = self._new_series()
            self._series[key] = s
        return s

    def _new_series(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def series(self) -> List[LabelValue]:
        with self._lock:
            return list(self._series.keys())

    def remove(self, **labels: str) -> bool:
        """Drop one labeled series; True when it existed.

        Retiring a label set (an unregistered index, a dead registry
        version) must also retire its series, or the exporter keeps
        publishing the last value forever — a gauge that can never go
        away reads as a leak that never resolves."""
        with self._lock:
            return self._series.pop(_label_key(labels), None) is not None

    def remove_matching(self, **labels: str) -> int:
        """Drop every series whose labels include ``labels``; returns the
        count removed (``index=x`` clears all of x's versions at once)."""
        want = set(_label_key(labels))
        with self._lock:
            dead = [k for k in self._series if want.issubset(set(k))]
            for k in dead:
                del self._series[k]
            return len(dead)


class Counter(_Metric):
    """Monotonically increasing count (requests, compiles, errors)."""

    kind = "counter"

    def _new_series(self) -> List[float]:
        return [0.0]

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._get_series(labels)[0] += value

    def value(self, **labels: str) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return float(s[0]) if s is not None else 0.0

    def collect(self) -> Dict[LabelValue, float]:
        with self._lock:
            return {k: float(v[0]) for k, v in self._series.items()}


class Gauge(_Metric):
    """Last-write-wins instantaneous value (queue depth, index size)."""

    kind = "gauge"

    def _new_series(self) -> List[float]:
        return [0.0]

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._get_series(labels)[0] = float(value)

    def inc(self, value: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._get_series(labels)[0] += value

    def value(self, **labels: str) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return float(s[0]) if s is not None else 0.0

    def collect(self) -> Dict[LabelValue, float]:
        with self._lock:
            return {k: float(v[0]) for k, v in self._series.items()}


class _HistSeries:
    __slots__ = ("bucket_counts", "sum", "count", "reservoir", "exemplars")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets  # non-cumulative, per bucket
        self.sum = 0.0
        self.count = 0
        self.reservoir: List[float] = []
        #: bucket index -> (observed value, exemplar id); last-write-wins,
        #: so storage is bounded by the ladder length, not traffic
        self.exemplars: Dict[int, Tuple[float, str]] = {}


class Histogram(_Metric):
    """Observations bucketed into a fixed ladder + bounded raw reservoir.

    Bucket semantics match Prometheus: ``bucket_counts[i]`` counts
    observations with ``value <= buckets[i]`` (exclusive of earlier
    buckets); values above the last edge land in the implicit ``+Inf``
    overflow slot (index ``len(buckets)``).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 max_series: int, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 reservoir: int = _RESERVOIR):
        super().__init__(name, help, lock, max_series)
        b = [float(x) for x in buckets]
        if not b or sorted(b) != b:
            raise ValueError(f"histogram {name!r} needs ascending buckets")
        self.buckets: Tuple[float, ...] = tuple(b)
        self._reservoir_cap = int(reservoir)

    def _new_series(self) -> _HistSeries:
        return _HistSeries(len(self.buckets) + 1)  # +1: +Inf overflow

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels: str) -> None:
        """Record ``value``.  ``exemplar`` (a request/span id) is retained
        per destination bucket, last-write-wins — the link from a fat p99
        bucket back to a concrete flight-recorder entry.  ``exemplar`` is
        a reserved keyword, not a label."""
        value = float(value)
        # the first bucket with value <= edge (NaN: the +Inf slot), outside
        # the lock (buckets are immutable)
        lo = bisect.bisect_left(self.buckets, value) if value == value else len(self.buckets)
        with self._lock:
            s = self._get_series(labels)
            s.bucket_counts[lo] += 1
            s.sum += value
            s.count += 1
            if exemplar is not None:
                s.exemplars[lo] = (value, str(exemplar))
            res = s.reservoir
            if len(res) >= self._reservoir_cap:
                # ring overwrite: keep a sliding window of recent values
                res[s.count % self._reservoir_cap] = value
            else:
                res.append(value)

    def percentile(self, q: float, **labels: str) -> Optional[float]:
        """Exact percentile over the (bounded) reservoir; None when empty."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or not s.reservoir:
                return None
            arr = np.asarray(s.reservoir, dtype=np.float64)
        return float(np.percentile(arr, q))

    def collect(self) -> Dict[LabelValue, Dict[str, object]]:
        with self._lock:
            out = {}
            for k, s in self._series.items():
                out[k] = {
                    "bucket_counts": list(s.bucket_counts),
                    "sum": float(s.sum),
                    "count": int(s.count),
                    "reservoir": np.asarray(s.reservoir, dtype=np.float64),
                    "exemplars": dict(s.exemplars),
                }
        return out

    def bucket_totals(self) -> Dict[LabelValue, Tuple[List[int], int]]:
        """``{labels: (bucket_counts, count)}`` — the cheap read for
        periodic pollers (the SLO evaluator).  Unlike :meth:`collect`
        this copies no reservoirs or exemplars, so the lock — shared
        with hot-path ``observe()`` — is held for O(buckets) per series
        instead of O(reservoir)."""
        with self._lock:
            return {
                k: (list(s.bucket_counts), int(s.count))
                for k, s in self._series.items()
            }

    def bucket_edge(self, i: int) -> float:
        """Upper edge of bucket ``i`` (``inf`` for the overflow slot)."""
        return self.buckets[i] if i < len(self.buckets) else float("inf")

    def clear_exemplars(self) -> None:
        """Drop retained exemplars on every series (test isolation)."""
        with self._lock:
            for s in self._series.values():
                s.exemplars.clear()

    def snapshot_series(self, k: LabelValue, data: Dict[str, object]
                        ) -> Dict[str, object]:
        """JSON-safe view of one collected series (percentiles in ms)."""
        arr = data["reservoir"]
        out: Dict[str, object] = {
            "count": data["count"],
            "sum": data["sum"],
        }
        if getattr(arr, "size", 0):
            for q in (50, 90, 99):
                out[f"p{q}_ms"] = float(np.percentile(arr, q) * 1e3)
        exemplars = data.get("exemplars")
        if exemplars:
            out["exemplars"] = [
                {
                    # "+Inf" keeps the overflow edge strict-JSON-safe
                    "le": (e if e != float("inf") else "+Inf"),
                    "value": v,
                    "id": ex,
                }
                for i, (v, ex) in sorted(exemplars.items())
                for e in (self.bucket_edge(i),)
            ]
        return out


class MetricsRegistry:
    """Named metrics + pluggable snapshot providers, all thread-safe.

    One instance normally lives for the whole process (module-level
    :func:`raft_tpu_torch.obs.registry`); tests build private ones.
    """

    def __init__(self, *, max_series: int = MAX_SERIES):
        self._lock = threading.Lock()          # guards metric/provider maps
        self._series_lock = threading.Lock()   # shared by all series updates
        self._metrics: Dict[str, _Metric] = {}
        self._providers: Dict[str, Callable[[], Dict[str, object]]] = {}
        self._max_series = max_series

    # -- metric constructors (get-or-create, type-checked) ------------------
    def _named(self, name: str, cls, **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, lock=self._series_lock,
                        max_series=self._max_series, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._named(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._named(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._named(name, Histogram, help=help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- providers: external components merged into snapshots ---------------
    def register_provider(
        self, name: str, fn: Callable[[], Dict[str, object]]
    ) -> None:
        """Merge ``fn()`` (a JSON-safe dict) under ``name`` in snapshots.
        Re-registering a name replaces the previous provider."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str, expected=None) -> None:
        """Remove provider ``name``.  With ``expected``, remove only when
        the registered callable is that exact one — so tearing down a
        replaced component can't detach its successor's provider."""
        with self._lock:
            if expected is None or self._providers.get(name) == expected:
                self._providers.pop(name, None)

    # -- reading -------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """One JSON-safe dict: all metrics + all provider sections."""
        out: Dict[str, object] = {
            "counters": {}, "gauges": {}, "histograms": {},
        }
        for m in self.metrics():
            if isinstance(m, Counter):
                out["counters"][m.name] = {
                    _fmt_labels(k): v for k, v in m.collect().items()
                }
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = {
                    _fmt_labels(k): v for k, v in m.collect().items()
                }
            elif isinstance(m, Histogram):
                out["histograms"][m.name] = {
                    _fmt_labels(k): m.snapshot_series(k, d)
                    for k, d in m.collect().items()
                }
        with self._lock:
            providers = dict(self._providers)
        for name, fn in providers.items():
            try:
                out[name] = fn()
            except Exception as exc:  # provider bugs must not kill snapshots
                out[name] = {"error": repr(exc)}
        return out

    def clear_exemplars(self) -> None:
        """Drop retained histogram exemplars without touching counts —
        the between-tests reset (exemplars are last-write-wins state)."""
        for m in self.metrics():
            if isinstance(m, Histogram):
                m.clear_exemplars()

    def reset(self) -> None:
        """Drop all metrics and providers (tests / long-lived REPLs)."""
        with self._lock:
            self._metrics.clear()
            self._providers.clear()


def _fmt_labels(key: LabelValue) -> str:
    """Stable human/JSON key for one label set ('' for the bare series)."""
    return ",".join(f"{k}={v}" for k, v in key)


# ---------------------------------------------------------------------------
# the process-wide default registry

_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default
