"""Exporters: Prometheus / OpenMetrics text and JSON snapshots
(counterpart of ``raft_tpu.obs.export``; the same registry contents give
the same text as raft_tpu's).  Output is deterministic (metrics and series
sorted).
"""

from __future__ import annotations

import json
import re
from typing import Dict, Optional

from raft_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    LabelValue,
    MetricsRegistry,
    default_registry,
)

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")

#: the canonical scrape content types — every HTTP surface (the
#: operational gateway, user-wired handlers, docs) must cite these two
#: constants rather than re-inlining the literals
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

_OPENMETRICS_MEDIA = "application/openmetrics-text"
_CLASSIC_MEDIA = ("text/plain", "text/*", "*/*", "")


def negotiate_content_type(accept: Optional[str]) -> str:
    """Pick the exposition format an ``Accept`` header asks for.

    Returns :data:`OPENMETRICS_CONTENT_TYPE` when the client lists
    ``application/openmetrics-text`` with a quality at least as high as
    any classic-text alternative (Prometheus's scraper sends exactly
    that when OpenMetrics ingestion is on), else
    :data:`PROMETHEUS_CONTENT_TYPE`.  Malformed q-values are treated as
    1.0 — a scrape endpoint should degrade to *an* answer, never to 400.
    """
    if not accept:
        return PROMETHEUS_CONTENT_TYPE
    q_open, q_classic = 0.0, 0.0
    for part in accept.split(","):
        params = part.split(";")
        media = params[0].strip().lower()
        q = 1.0
        for p in params[1:]:
            k, _, v = p.partition("=")
            if k.strip().lower() == "q":
                try:
                    q = float(v.strip())
                except ValueError:
                    q = 1.0
        if media == _OPENMETRICS_MEDIA:
            q_open = max(q_open, q)
        elif media in _CLASSIC_MEDIA:
            q_classic = max(q_classic, q)
    if q_open > 0.0 and q_open >= q_classic:
        return OPENMETRICS_CONTENT_TYPE
    return PROMETHEUS_CONTENT_TYPE


def _sanitize(name: str, label: bool = False) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]" if not label else r"[^a-zA-Z0-9_]",
                 "_", name)
    if not out or not out[0].isalpha() and out[0] != "_":
        out = "_" + out
    return out


def _escape_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt_series(name: str, labels: LabelValue,
                extra: Optional[Dict[str, str]] = None) -> str:
    items = [(k, v) for k, v in labels]
    if extra:
        items += list(extra.items())
    if not items:
        return name
    body = ",".join(
        f'{_sanitize(k, label=True)}="{_escape_value(str(v))}"'
        for k, v in items
    )
    return f"{name}{{{body}}}"


def _fmt_float(x: float) -> str:
    if x == float("inf"):
        return "+Inf"
    if float(x).is_integer() and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


def _render(reg: MetricsRegistry, openmetrics: bool) -> str:
    lines = []
    for m in sorted(reg.metrics(), key=lambda m: m.name):
        name = _sanitize(m.name)
        assert _NAME_OK.match(name)
        if m.help:
            lines.append(f"# HELP {name} {_escape_value(m.help)}")
        lines.append(f"# TYPE {name} {m.kind}")
        if isinstance(m, (Counter, Gauge)):
            data = m.collect()
            for k in sorted(data.keys()):
                lines.append(f"{_fmt_series(name, k)} {_fmt_float(data[k])}")
        elif isinstance(m, Histogram):
            data = m.collect()
            for k in sorted(data.keys()):
                d = data[k]
                cum = 0
                exemplars = d.get("exemplars") or {}
                edges = list(m.buckets) + [float("inf")]
                for i, (edge, n) in enumerate(zip(edges, d["bucket_counts"])):
                    cum += n
                    line = (
                        f"{_fmt_series(name + '_bucket', k, {'le': _fmt_float(edge)})}"
                        f" {cum}"
                    )
                    if openmetrics and i in exemplars:
                        # OpenMetrics exemplar: the bucket's retained
                        # request/span id + the observed value it came with
                        value, ex_id = exemplars[i]
                        line += (
                            f' # {{request_id="{_escape_value(str(ex_id))}"}}'
                            f" {_fmt_float(value)}"
                        )
                    lines.append(line)
                lines.append(
                    f"{_fmt_series(name + '_sum', k)} {_fmt_float(d['sum'])}"
                )
                lines.append(
                    f"{_fmt_series(name + '_count', k)} {d['count']}"
                )
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n" if lines else ""


def to_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render ``registry`` (default: process registry) as Prometheus text.

    Classic text exposition 0.0.4 — deliberately exemplar-free, because
    plain-Prometheus scrapers reject the OpenMetrics exemplar syntax.
    Use :func:`to_openmetrics` for the exemplar-bearing document.
    """
    reg = registry if registry is not None else default_registry()
    return _render(reg, openmetrics=False)


def to_openmetrics(registry: Optional[MetricsRegistry] = None) -> str:
    """Render ``registry`` as OpenMetrics text with histogram exemplars.

    Identical to :func:`to_prometheus` except each ``_bucket`` line whose
    bucket retains an exemplar gains the OpenMetrics suffix
    ``# {request_id="req-123"} <observed value>`` — the hop from a fat
    p99 bucket to the flight recorder's record of that request — and the
    document ends with the mandatory ``# EOF`` marker.  Serve scrape
    endpoints that negotiate ``application/openmetrics-text`` should
    return this form.
    """
    reg = registry if registry is not None else default_registry()
    return _render(reg, openmetrics=True)


def snapshot_json(registry: Optional[MetricsRegistry] = None,
                  indent: Optional[int] = None) -> str:
    """The registry snapshot serialized to a JSON string."""
    reg = registry if registry is not None else default_registry()
    return json.dumps(reg.snapshot(), indent=indent, default=str)


def write_snapshot(path: str,
                   registry: Optional[MetricsRegistry] = None) -> None:
    """Dump a JSON snapshot to ``path`` (atomic-enough single write)."""
    with open(path, "w") as f:
        f.write(snapshot_json(registry, indent=2))
