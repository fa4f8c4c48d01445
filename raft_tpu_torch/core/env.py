"""Typed access to the ``RAFT_TPU_*`` settings the port honours
(counterpart of ``raft_tpu.core.env``).

Every setting the port reads is declared once in :data:`KNOWN_VARS` (name,
type, default and one-line effect) and read through a typed accessor
(:func:`env_str` / :func:`env_int` / :func:`env_float` /
:func:`env_bool`), which raises :class:`UnknownEnvVarError` on an
undeclared name and ``TypeError`` when the accessor's type is not the
declared one.  The table is the registry the ENVREG checker
(``python -m raft_tpu_torch.analysis``) reconciles against the call sites
and against the port's own environment table in the README's "PyTorch /
H100 port" section, so a setting cannot exist without its row there.

The port declares the names it reads, with raft_tpu's defaults, and the
multi-GPU settings (the merge dtype of ``serve.shard``, the CAGRA shard
mode, the reduce dtype of the sharded fits, and the rendezvous of
``comms.initialize``).  Reads stay at their point of use; no global config
object is built from the table.

This module imports nothing of the port: the analysis CLI and the tests
load it standalone.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = [
    "EnvVar",
    "KNOWN_VARS",
    "UnknownEnvVarError",
    "env_str",
    "env_int",
    "env_float",
    "env_bool",
    "has",
    "raw",
    "known",
]


@dataclass(frozen=True)
class EnvVar:
    """One declared setting: the registry row the checkers reconcile."""

    name: str
    kind: str        # "str" | "int" | "float" | "bool"
    default: str     # human-readable default, as the README table shows it
    help: str        # one-line effect


#: every environment variable the port reads: the one source the README's
#: port table must mirror
KNOWN_VARS: Tuple[EnvVar, ...] = (
    EnvVar("RAFT_TPU_PIPELINE_DEPTH", "int", "2",
           "serving in-flight window: device batches the MicroBatcher overlaps "
           "on its CUDA stream; 1 = fully serial dispatch"),
    EnvVar("RAFT_TPU_COST_ACCOUNTING", "bool", "1",
           "0 skips the per-bucket cost/memory gauges at warmup"),
    EnvVar("RAFT_TPU_SHARD_MERGE_DTYPE", "str", "float32",
           "bfloat16 rounds the ShardedIndex candidate distances gathered for "
           "the cross-shard merge"),
    EnvVar("RAFT_TPU_SHARD_CAGRA", "str", "brute",
           "how a sharded CAGRA index serves: brute (row-partitioned brute "
           "force, exact); graph (partitioned traversal) is not ported and "
           "raises"),
    EnvVar("RAFT_TPU_RAGGED", "bool", "unset",
           "1 serves SearchService indexes in ragged mode: per-request k and "
           "filter id packed as descriptor data into one dispatch per capacity "
           "bucket"),
    EnvVar("RAFT_TPU_RAGGED_KMAX", "int", "32",
           "ragged serving's static top-k capacity — every dispatch computes "
           "this many columns; per-request k may not exceed it"),
    EnvVar("RAFT_TPU_RAGGED_FILTERS", "bool", "1",
           "0 drops the per-request filter-id column from ragged dispatches "
           "(skips the RowFilter gather when no filters are registered)"),
    EnvVar("RAFT_TPU_OVERLOAD", "bool", "unset",
           "1 installs the overload actuators (admission control + degraded- "
           "mode search) on every SearchService index"),
    EnvVar("RAFT_TPU_OVERLOAD_ADMIT_WAIT_S", "float", "0.25",
           "oldest queued request wait that counts as pressure level 1 at "
           "batch cut (each doubling adds a level)"),
    EnvVar("RAFT_TPU_OVERLOAD_QUEUE_FACTOR", "float", "8.0",
           "queue depth in units of max_batch that counts as pressure level 1 "
           "(each doubling adds a level)"),
    EnvVar("RAFT_TPU_OVERLOAD_DEGRADE_AFTER_S", "float", "1.0",
           "sustained pressure before the degraded-search level steps up one "
           "notch"),
    EnvVar("RAFT_TPU_OVERLOAD_RESTORE_AFTER_S", "float", "5.0",
           "sustained calm before the degraded-search level steps back down "
           "one notch (hysteresis against flapping)"),
    EnvVar("RAFT_TPU_OVERLOAD_MAX_DEGRADE", "int", "2",
           "deepest degraded-search level (each level halves n_probes / "
           "itopk_size; every level is warmed)"),
    EnvVar("RAFT_TPU_OVERLOAD_HEDGE", "bool", "unset",
           "1 hedges priority-0 dispatches across replica-group members "
           "(replicas are not ported: ROADMAP Queue 1 item 7b)"),
    EnvVar("RAFT_TPU_OVERLOAD_HEDGE_MULT", "float", "3.0",
           "hedge delay as a multiple of the live p99 latency"),
    EnvVar("RAFT_TPU_OVERLOAD_HEDGE_MIN_S", "float", "0.005",
           "hedge delay floor in seconds (used verbatim before the latency "
           "reservoir has data)"),
    EnvVar("RAFT_TPU_COMPACT_DISABLED", "bool", "unset",
           "1 keeps the compaction worker down even when "
           "SearchService(compaction=True)"),
    EnvVar("RAFT_TPU_COMPACT_MAX_SIDE_ROWS", "int", "1024",
           "live side-buffer rows that trigger a compaction pass"),
    EnvVar("RAFT_TPU_COMPACT_MAX_TOMBSTONE_FRAC", "float", "0.25",
           "tombstoned fraction of main rows that triggers a pass"),
    EnvVar("RAFT_TPU_COMPACT_INTERVAL_S", "float", "2.0",
           "compaction worker scan period"),
    EnvVar("RAFT_TPU_COMPACT_COOLDOWN_S", "float", "30",
           "per-index re-arm delay after an aborted pass"),
    EnvVar("RAFT_TPU_COMPACT_HEADROOM_FRAC", "float", "4.0",
           "memory budget: projected peak rebuild bytes may not exceed this "
           "fraction of the live index's bytes"),
    EnvVar("RAFT_TPU_COMPACT_CHUNK_ROWS", "int", "65536",
           "main-structure decode chunk during the shadow gather"),
    EnvVar("RAFT_TPU_COMPACT_GATE_QUERIES", "int", "64",
           "held-back sample size for the recall gate"),
    EnvVar("RAFT_TPU_COMPACT_RECALL_SLACK", "float", "0.02",
           "gate tolerance: shadow recall may trail serving recall by at most "
           "this"),
    EnvVar("RAFT_TPU_PAGED", "bool", "unset",
           "1 serves SearchService indexes from paged storage (host cold pages "
           "+ a budget-sized device pool); unpaged monolithic buffers stay the "
           "default"),
    EnvVar("RAFT_TPU_PAGE_ROWS", "int", "1024",
           "rows per storage page (multiple of 8; IVF list capacity repads to "
           "a page multiple)"),
    EnvVar("RAFT_TPU_PAGE_HBM_BUDGET_MB", "int", "unset",
           "hard device-memory budget for paged pools (and the compactor's "
           "projected-bytes gate); unset sizes pools to hold every page"),
    EnvVar("RAFT_TPU_PAGE_PREFETCH_DEPTH", "int", "2",
           "bounded queue depth of the async page-prefetch worker (full queue "
           "drops the hint; prefetch is advisory)"),
    EnvVar("RAFT_TPU_BUILD_REDUCE_DTYPE", "str", "float32",
           "bfloat16/int8 quantizes the per-iteration centroid-statistics "
           "allreduce of the sharded k-means fits"),
    EnvVar("RAFT_TPU_OBS_DISABLED", "bool", "unset",
           "1 disables span recording entirely (metrics stay on)"),
    EnvVar("RAFT_TPU_SLOW_QUERY_MS", "float", "250",
           "slow-query log threshold (spans over it are recorded with their "
           "stage anatomy)"),
    EnvVar("RAFT_TPU_SPAN_RING", "int", "512",
           "capacity of the finished-span ring behind obs.recent_spans()"),
    EnvVar("RAFT_TPU_FLIGHT_CAP", "int", "256",
           "flight-recorder ring size (batch + event records kept for incident "
           "dumps)"),
    EnvVar("RAFT_TPU_FLIGHT_DIR", "str", "system temp",
           "where auto/manual flight dumps (JSON + Chrome trace) are written"),
    EnvVar("RAFT_TPU_FLIGHT_DEBOUNCE_S", "float", "60",
           "minimum seconds between auto-dumps; suppressed triggers are "
           "counted"),
    EnvVar("RAFT_TPU_EXPLAIN", "bool", "unset",
           "1 enables always-on explain tail sampling (the QueryArchive "
           "retains full plans for the interesting tail; deep explains work "
           "without it)"),
    EnvVar("RAFT_TPU_EXPLAIN_ARCHIVE_CAP", "int", "128",
           "query-archive ring size (archived ExplainPlans; oldest evicted "
           "first)"),
    EnvVar("RAFT_TPU_EXPLAIN_TAIL_PER_WINDOW", "int", "4",
           "slowest-N requests the explain tail sampler keeps per one-second "
           "window"),
    EnvVar("RAFT_TPU_EVENTS_RING", "int", "256",
           "obs event-bus recent-events ring capacity (overflow is counted, "
           "never blocking)"),
    EnvVar("RAFT_TPU_INCIDENT_WINDOW_S", "float", "5",
           "correlation window: trigger events this close join one incident "
           "(and share one flight dump)"),
    EnvVar("RAFT_TPU_INCIDENT_AUTOCLOSE_S", "float", "30",
           "quiet seconds after which an open incident auto-closes"),
    EnvVar("RAFT_TPU_INCIDENT_MAX_OPEN", "int", "8",
           "bound on simultaneously open incidents (excess triggers are "
           "counted, not tracked)"),
    EnvVar("RAFT_TPU_INCIDENT_DIR", "str", "flight dir",
           "where closed-incident JSON + Chrome-trace exports are written"),
    EnvVar("RAFT_TPU_SLO_WINDOW_SCALE", "float", "1.0",
           "scales every SLO window (eval period, burn windows, budget window) "
           "— tests shrink hours to milliseconds"),
    EnvVar("RAFT_TPU_SLO_EVAL_S", "float", "10",
           "SLO evaluator tick period (before window scaling)"),
    EnvVar("RAFT_TPU_SLO_BUDGET_WINDOW_S", "float", "2592000",
           "error-budget window (30 days, before window scaling)"),
    EnvVar("RAFT_TPU_SLO_AVAILABILITY", "float", "0.999",
           "default availability objective for watched indexes"),
    EnvVar("RAFT_TPU_SLO_P99_MS", "float", "250",
           "default latency-SLO target: requests over this are slow"),
    EnvVar("RAFT_TPU_SLO_RECALL", "float", "0.9",
           "default audited-recall objective for watched indexes"),
    EnvVar("RAFT_TPU_SLO_FRESHNESS_S", "float", "300",
           "default freshness target: max age of the oldest un-compacted "
           "mutation"),
    EnvVar("RAFT_TPU_AUTOTUNE", "bool", "unset",
           "1 runs the closed-loop SLO autotuner on every served index "
           "(SearchService(autotune=...) overrides)"),
    EnvVar("RAFT_TPU_AUTOTUNE_EVAL_S", "float", "2",
           "autotuner tick period (scaled by RAFT_TPU_SLO_WINDOW_SCALE)"),
    EnvVar("RAFT_TPU_AUTOTUNE_RECALL_FLOOR", "float", "0.9",
           "recall EWMA floor the autotuner must hold while trading effort for "
           "QPS"),
    EnvVar("RAFT_TPU_FRONTIER_PATH", "str", "unset",
           "serialized FrontierModel (bench frontier sweep output) the "
           "autotuner navigates; unset falls back to the synthetic effort- "
           "ladder model"),
    EnvVar("RAFT_TPU_GATEWAY", "bool", "unset",
           "1 gives every SearchService an operational HTTP gateway "
           "(scrape/probe/debug endpoints; SearchService(gateway=...) "
           "overrides)"),
    EnvVar("RAFT_TPU_GATEWAY_PORT", "int", "0",
           "gateway listen port (0 binds an ephemeral port, read back from "
           "OperationalGateway.port)"),
    EnvVar("RAFT_TPU_GATEWAY_TOKEN", "str", "unset",
           "bearer token the gateway's POST /admin plane requires; admin-on "
           "without a token refuses every admin request"),
    EnvVar("RAFT_TPU_GATEWAY_ADMIN", "bool", "unset",
           "1 enables the gateway's POST /admin plane (compact, effort_pin, "
           "flight_dump, archive_dump); off, those routes 404"),
    EnvVar("RAFT_TPU_DISABLE_PROFILER", "bool", "unset",
           "1 disables the core.trace.profile capture helper"),
    EnvVar("RAFT_TPU_PERF_LEDGER", "bool", "1",
           "0 disables the measured perf ledger (per-dispatch device-time "
           "attribution + regression detection)"),
    EnvVar("RAFT_TPU_PERF_EWMA_ALPHA", "float", "0.25",
           "fast-EWMA weight of the per-bucket device-time regression detector "
           "(the slow baseline uses alpha/8)"),
    EnvVar("RAFT_TPU_PERF_REGRESSION_X", "float", "1.5",
           "regression trip ratio: fast device-time EWMA over this multiple of "
           "the slow baseline publishes perf_regression"),
    EnvVar("RAFT_TPU_PERF_MIN_SAMPLES", "int", "32",
           "dispatches per ledger key before the regression detector arms "
           "(warm baselines only)"),
    EnvVar("RAFT_TPU_PERF_DEBOUNCE_S", "float", "60",
           "minimum seconds between perf_regression events (and profile "
           "captures) per ledger key"),
    EnvVar("RAFT_TPU_PERF_CAPTURE_S", "float", "1.0",
           "duration of the auto profile capture a perf_regression triggers (0 "
           "disables the capture, the event still fires)"),
    EnvVar("RAFT_TPU_PERF_CAPTURE_DIR", "str", "flight dir",
           "where regression-triggered profiler captures are written"),
    EnvVar("RAFT_TPU_PEAK_FLOPS", "float", "per-platform",
           "roofline FLOP/s peak for obs.cost utilization estimates (default: "
           "the H100's, ops.cost)"),
    EnvVar("RAFT_TPU_PEAK_BW", "float", "per-platform",
           "roofline bytes/s peak for obs.cost utilization estimates (default: "
           "the H100's, ops.cost)"),
    EnvVar("RAFT_TPU_COORDINATOR", "str", "unset",
           "multi-process torch.distributed rendezvous address (host:port) for "
           "comms.initialize"),
    EnvVar("RAFT_TPU_NUM_PROCS", "int", "unset",
           "multi-process torch.distributed world size for comms.initialize"),
    EnvVar("RAFT_TPU_PROC_ID", "int", "unset",
           "multi-process torch.distributed rank for comms.initialize"),
    EnvVar("RAFT_TPU_BENCH_RECORD", "str", "BENCH_last.json",
           "bench record artifact path (- suppresses)"),
)

_KNOWN: Dict[str, EnvVar] = {v.name: v for v in KNOWN_VARS}

#: values env_bool reads as False when the variable IS set; anything else
#: set is True
_FALSY = frozenset({"", "0", "false", "no", "off"})


class UnknownEnvVarError(KeyError):
    """A read of a ``RAFT_TPU_*`` name missing from :data:`KNOWN_VARS`."""


def _declared(name: str, kind: str) -> EnvVar:
    var = _KNOWN.get(name)
    if var is None:
        raise UnknownEnvVarError(
            f"{name} is not declared in raft_tpu_torch.core.env.KNOWN_VARS; "
            "add a row (and a row of the README's port table) before reading it"
        )
    if var.kind != kind:
        raise TypeError(
            f"{name} is declared as {var.kind!r} but read as {kind!r}; "
            "fix the accessor or the KNOWN_VARS row"
        )
    return var


def known(name: str) -> bool:
    """Whether ``name`` is a declared setting."""
    return name in _KNOWN


def has(name: str) -> bool:
    """Whether the declared setting ``name`` is set in the environment."""
    if name not in _KNOWN:
        raise UnknownEnvVarError(
            f"{name} is not declared in raft_tpu_torch.core.env.KNOWN_VARS")
    return name in os.environ


def raw(name: str) -> Optional[str]:
    """The raw string value of a declared setting, ``None`` when unset
    (save / restore around a scoped override, where unset and empty
    differ)."""
    if name not in _KNOWN:
        raise UnknownEnvVarError(
            f"{name} is not declared in raft_tpu_torch.core.env.KNOWN_VARS")
    return os.environ.get(name)


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """``os.environ[name]``, or ``default`` when unset."""
    _declared(name, "str")
    return os.environ.get(name, default)


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """``int(os.environ[name])``; unset or blank reads as ``default``."""
    _declared(name, "int")
    value = os.environ.get(name)
    if value is None or not value.strip():
        return default
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}={value!r} is not an integer") from None


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    """``float(os.environ[name])``; unset or blank reads as ``default``."""
    _declared(name, "float")
    value = os.environ.get(name)
    if value is None or not value.strip():
        return default
    try:
        return float(value)
    except ValueError:
        raise ValueError(f"{name}={value!r} is not a number") from None


def env_bool(name: str, default: bool = False) -> bool:
    """Unset reads as ``default``; "", "0", "false", "no" and "off" (any
    case) read as False, anything else as True."""
    _declared(name, "bool")
    value = os.environ.get(name)
    if value is None:
        return default
    return value.strip().lower() not in _FALSY
