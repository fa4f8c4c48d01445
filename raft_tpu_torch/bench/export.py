"""Result export: CSV tables, versioned bench records, and the comparison
of two records (counterpart of ``raft_tpu.bench.export``).

Every record carries ``kernel_path``, the leg its numbers came from:
``"cuda"`` (the hand-written kernels of ``csrc/``) or ``"torch"`` (the plain
versions, on the CPU), where raft_tpu stamps its Pallas / XLA choice.
:func:`compare_records` holds a candidate to a baseline with noise-aware
limits: throughput and latency relative (default 25 %), recall absolute.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Tuple

import torch

from raft_tpu_torch.bench.runner import RunResult
from raft_tpu_torch.core import env as _env

_FIELDS = [
    "algo", "dataset", "k", "build_param", "search_param",
    "build_time_s", "qps", "latency_ms", "recall", "end_to_end_s",
    "device_time_s", "device_qps",
]

#: the record envelope's version (raft_tpu's, so records of both packages load)
BENCH_SCHEMA_VERSION = 1

#: environment variable naming the default record path
RECORD_PATH_ENV = "RAFT_TPU_BENCH_RECORD"
DEFAULT_RECORD_PATH = "BENCH_last.json"


def to_csv(results: List[RunResult], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=_FIELDS)
        w.writeheader()
        for r in results:
            d = r.to_dict()
            d["build_param"] = json.dumps(d["build_param"])
            d["search_param"] = json.dumps(d["search_param"])
            w.writerow(d)


def from_json(path: str) -> List[RunResult]:
    with open(path) as fh:
        return [RunResult(**d) for d in json.load(fh)]


def kernel_path(device=None) -> str:
    """The leg a record's numbers come from: ``"cuda"`` for work on a CUDA
    device (default: the card, when there is one), ``"torch"`` on the CPU."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "torch"
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def bench_record(payload: Dict[str, object]) -> Dict[str, object]:
    """One bench payload (a dict with a ``metric``) in the versioned
    envelope, ``kernel_path`` stamped when the payload lacks it."""
    if not isinstance(payload, dict) or "metric" not in payload:
        raise ValueError("bench payload must be a dict with a 'metric' key, got "
                         f"{type(payload).__name__}")
    rec = dict(payload)
    rec.setdefault("kernel_path", kernel_path())
    return {"schema": "raft_tpu.bench", "schema_version": BENCH_SCHEMA_VERSION, "record": rec}


def write_bench_record(payload: Dict[str, object], path: Optional[str] = None) -> str:
    """Write the enveloped record; returns the path written.  The default
    path is ``$RAFT_TPU_BENCH_RECORD`` (``-`` or empty: no write), else
    ``BENCH_last.json`` in the working directory."""
    if path is None:
        path = _env.env_str(RECORD_PATH_ENV, DEFAULT_RECORD_PATH)
    if not path or path == "-":
        return ""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(bench_record(payload), fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def load_record(path: str) -> Dict[str, object]:
    """A bench payload from the envelope, the ``BENCH_r0N.json`` wrapper
    (payload under ``"parsed"``) or a bare payload."""
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: expected a JSON object, got {type(doc).__name__}")
    if doc.get("schema") == "raft_tpu.bench":
        ver = doc.get("schema_version")
        if ver != BENCH_SCHEMA_VERSION:
            raise ValueError(f"{path}: unsupported bench schema_version {ver!r} "
                             f"(this build reads {BENCH_SCHEMA_VERSION})")
        payload = doc.get("record")
    elif "parsed" in doc:
        payload = doc["parsed"]
    else:
        payload = doc
    if not isinstance(payload, dict) or "metric" not in payload:
        raise ValueError(f"{path}: no bench payload with a 'metric' key")
    return payload


#: units where a larger value is better; the rest (ms, s) smaller is better
_HIGHER_IS_BETTER_UNITS = ("/s", "qps", "ops")


def _higher_is_better(unit: str) -> bool:
    u = (unit or "").lower()
    return any(tok in u for tok in _HIGHER_IS_BETTER_UNITS)


def compare_records(baseline: Dict[str, object], candidate: Dict[str, object], *,
                    rtol: float = 0.25, recall_atol: float = 0.02) -> Tuple[bool, List[str]]:
    """Two bench payloads: (ok, report lines).  Not ok when the value is worse
    than the baseline's by more than ``rtol`` (its direction from ``unit``),
    a latency is worse by more than ``rtol``, recall falls by more than
    ``recall_atol``, or recompiles appear where the baseline had none.
    Records of other metrics or platforms are skipped (ok)."""
    lines: List[str] = []
    ok = True
    b_metric, c_metric = baseline.get("metric"), candidate.get("metric")
    if b_metric != c_metric:
        lines.append(f"SKIP incomparable metrics: baseline={b_metric!r} candidate={c_metric!r}")
        return True, lines
    b_plat, c_plat = baseline.get("platform"), candidate.get("platform")
    if b_plat != c_plat:
        lines.append(f"SKIP incomparable platforms: baseline={b_plat!r} candidate={c_plat!r}")
        return True, lines
    lines.append(f"metric {b_metric} (platform={b_plat})")
    try:
        bv = float(baseline["value"])
        cv = float(candidate["value"])
    except (KeyError, TypeError, ValueError):
        lines.append("SKIP no comparable 'value' field")
        return True, lines
    unit = str(candidate.get("unit") or baseline.get("unit") or "")
    hib = _higher_is_better(unit)
    ratio = (cv / bv) if bv else float("inf")
    worse = ratio < (1.0 - rtol) if hib else ratio > (1.0 + rtol)
    lines.append(f"  value: {bv:g} -> {cv:g} {unit} ({ratio:.0%} of baseline, "
                 f"{'higher' if hib else 'lower'} is better, rtol={rtol:.0%}) "
                 f"{'REGRESSION' if worse else 'ok'}")
    ok &= not worse
    for field in ("p50_ms", "p99_ms", "latency_ms"):
        b, c = baseline.get(field), candidate.get(field)
        if b is None or c is None:
            continue
        b, c = float(b), float(c)
        if b <= 0:
            continue
        r = c / b
        worse = r > (1.0 + rtol)
        lines.append(f"  {field}: {b:g} -> {c:g} ({r:.0%} of baseline) "
                     f"{'REGRESSION' if worse else 'ok'}")
        ok &= not worse
    b, c = baseline.get("recall"), candidate.get("recall")
    if b is not None and c is not None:
        b, c = float(b), float(c)
        worse = c < b - recall_atol
        lines.append(f"  recall: {b:.4f} -> {c:.4f} (atol={recall_atol}) "
                     f"{'REGRESSION' if worse else 'ok'}")
        ok &= not worse
    b, c = baseline.get("recompiles"), candidate.get("recompiles")
    if b is not None and c is not None and int(b) == 0 and int(c) > 0:
        lines.append(f"  recompiles: 0 -> {int(c)} REGRESSION (hot-path XLA compiles reappeared)")
        ok = False
    b, c = baseline.get("kernel_path"), candidate.get("kernel_path")
    if (b is not None or c is not None) and b != c:
        lines.append(f"  kernel_path: {json.dumps(b)} -> {json.dumps(c)} "
                     "(info: sides ran different kernel routings)")
    lines.append("PASS" if ok else "FAIL")
    return ok, lines


def compare_main(argv: Optional[List[str]] = None) -> int:
    """``python -m raft_tpu_torch.bench compare --baseline X --candidate Y``:
    exit 0 on pass or skip, 1 on a regression, 2 on a usage or file error."""
    import argparse

    ap = argparse.ArgumentParser("bench compare",
                                 description="Diff two bench records with noise-aware limits.")
    ap.add_argument("--baseline", required=True, help="baseline record")
    ap.add_argument("--candidate", required=True, help="candidate record")
    ap.add_argument("--rtol", type=float, default=0.25,
                    help="relative tolerance for value/latency (default .25)")
    ap.add_argument("--recall-atol", type=float, default=0.02,
                    help="absolute tolerance for recall (default .02)")
    args = ap.parse_args(argv)
    try:
        baseline = load_record(args.baseline)
        candidate = load_record(args.candidate)
    except (OSError, ValueError) as e:
        print(f"compare: cannot load a record: {e}")
        return 2
    ok, lines = compare_records(baseline, candidate, rtol=args.rtol,
                                recall_atol=args.recall_atol)
    print("\n".join(lines))
    return 0 if ok else 1
