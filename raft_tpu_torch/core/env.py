"""Typed reads of the ``RAFT_TPU_*`` settings the port honours (the
accessors of ``raft_tpu.core.env`` it needs, with raft_tpu's semantics).

- ``RAFT_TPU_PAGE_HBM_BUDGET_MB``: the default device-memory budget of
  paged indexes (``store.budget``); unset means no budget.
- ``RAFT_TPU_PAGE_ROWS``: rows per page of ``store.paginate_index``
  (default 1024).
- ``RAFT_TPU_PAGE_PREFETCH_DEPTH``: the bounded prefetch queue of a
  ``store.TieredStore`` (default 2).
- ``RAFT_TPU_OBS_DISABLED``: spans off from import (``obs.set_enabled``).
- ``RAFT_TPU_SPAN_RING``: recent root spans kept (default 512).
- ``RAFT_TPU_SLOW_QUERY_MS``: the slow-query threshold (default 250).
- ``RAFT_TPU_EVENTS_RING``: recent bus events kept (default 256).
- ``RAFT_TPU_DISABLE_PROFILER``: ``core.trace.profile`` captures nothing.
- ``RAFT_TPU_PEAK_FLOPS`` / ``RAFT_TPU_PEAK_BW``: the peaks ``obs.cost``
  takes a roofline share against (default: the H100's, ``ops.cost``).

The serving layer (``serve``) and its observability read raft_tpu's
knobs with raft_tpu's defaults: ``RAFT_TPU_PIPELINE_DEPTH`` (2),
``RAFT_TPU_COST_ACCOUNTING`` (on), ``RAFT_TPU_RAGGED`` /
``_RAGGED_KMAX`` (32) / ``_RAGGED_FILTERS`` (on), ``RAFT_TPU_OVERLOAD`` and
``RAFT_TPU_OVERLOAD_*``, ``RAFT_TPU_COMPACT_*``, ``RAFT_TPU_PAGED``,
``RAFT_TPU_FLIGHT_{CAP,DIR,DEBOUNCE_S}``,
``RAFT_TPU_INCIDENT_{WINDOW_S,AUTOCLOSE_S,MAX_OPEN,DIR}``,
``RAFT_TPU_PERF_LEDGER`` and ``RAFT_TPU_PERF_*``, ``RAFT_TPU_EXPLAIN`` /
``_EXPLAIN_ARCHIVE_CAP`` / ``_EXPLAIN_TAIL_PER_WINDOW``.  Its optional obs
layers read the same: the SLO engine ``RAFT_TPU_SLO_WINDOW_SCALE`` (1.0),
``_EVAL_S`` (10), ``_BUDGET_WINDOW_S`` (30 days), ``_AVAILABILITY`` (0.999),
``_P99_MS`` (250), ``_RECALL`` (0.9) and ``_FRESHNESS_S`` (300); the
autotuner ``RAFT_TPU_AUTOTUNE`` (off), ``_AUTOTUNE_EVAL_S`` (2),
``_AUTOTUNE_RECALL_FLOOR`` (0.9) and ``RAFT_TPU_FRONTIER_PATH`` (unset: the
synthetic ladder model); the gateway ``RAFT_TPU_GATEWAY`` (off),
``_GATEWAY_PORT`` (0: an ephemeral port), ``_GATEWAY_TOKEN`` (unset) and
``_GATEWAY_ADMIN`` (off).  ``python -m raft_tpu_torch.bench frontier`` writes
its record to ``RAFT_TPU_BENCH_RECORD`` when it is set.
"""

from __future__ import annotations

import os
from typing import Optional


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """``os.environ[name]``, or ``default`` when unset."""
    return os.environ.get(name, default)


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """``int(os.environ[name])``; unset or blank reads as ``default``."""
    value = os.environ.get(name)
    if value is None or not value.strip():
        return default
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}={value!r} is not an integer") from None


_FALSY = frozenset({"", "0", "false", "no", "off"})


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    """``float(os.environ[name])``; unset or blank reads as ``default``."""
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
    value = os.environ.get(name)
    if value is None:
        return default
    return value.strip().lower() not in _FALSY
