"""Port parity of the serving observability on the CPU: the flight
recorder's Chrome trace, health verdicts, the perf ledger's accounting and
regression trips, the explain tail sampler, and incident correlation equal
raft_tpu's on the same inputs; the profiler wrappers write their traces."""

import os
import time

import numpy as np
import pytest
import torch

from raft_tpu.obs import events as jevents
from raft_tpu.obs import explain as jexplain
from raft_tpu.obs import flight as jflight
from raft_tpu.obs import health as jhealth
from raft_tpu.obs import incidents as jincidents
from raft_tpu.obs import perf as jperf
from raft_tpu_torch.obs import events as tevents
from raft_tpu_torch.obs import explain as texplain
from raft_tpu_torch.obs import flight as tflight
from raft_tpu_torch.obs import health as thealth
from raft_tpu_torch.obs import incidents as tincidents
from raft_tpu_torch.obs import perf as tperf
from raft_tpu_torch.obs import profiler as tprofiler

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _records():
    rec = {"seq": 1, "index": "a", "bucket": 4, "rows": 3, "compiles": 0,
           "request_ids": [7, 8], "t_pickup": 10.0, "t_done": 10.004,
           "stages_s": {"pad": 1e-4, "dispatch": 1e-3, "device": 2e-3},
           "waits_s": {"queue": 5e-4}, "kernel_path": "cuda", "hedged": False,
           "requests": [{"id": 7, "rows": 1, "submit": 9.999, "resolve": 10.004,
                         "latency_ms": 5.0},
                        {"id": 8, "rows": 2, "submit": 9.9995, "resolve": 10.004,
                         "latency_ms": 4.5}], "error": None}
    return [rec, dict(rec, seq=2, error="boom"), {"kind": "rebuild", "t": 11.0}]


def test_flight_trace_events_and_ring_match_raft_tpu(tmp_path):
    assert tflight.trace_events(_records()) == [
        {**e, "args": {**e["args"], "name": "raft_tpu_torch.serve"}}
        if e.get("name") == "process_name" else e
        for e in jflight.trace_events(_records())]
    rec = tflight.FlightRecorder(cap=2, debounce_s=0.0)
    for r in _records():
        rec.record_batch(r)
    assert [r.get("seq") for r in rec.records()] == [2, None]
    path = rec.dump(str(tmp_path), reason="unit")
    assert os.path.basename(path) == "flight_0001_unit.json" and rec.last_dump()["path"] == path


@pytest.mark.parametrize("probe", [
    dict(warm=True, recompiles=0, queue_depth=3, max_batch=64),
    dict(warm=False, recompiles=2, queue_depth=300, max_batch=64),
    dict(warm=True, recompiles=6, queue_depth=5000, max_batch=64, inflight=3, pipeline_depth=2),
    dict(warm=True, recompiles=0, queue_depth=0, max_batch=8, compaction_backlog=90,
         compaction_trigger=10, admission_level=1, degraded_level=0),
    dict(warm=True, recompiles=0, queue_depth=0, max_batch=8, compaction_backlog=1,
         compaction_trigger=10, compaction_last_abort="gate"),
])
def test_health_verdicts_match_raft_tpu(probe):
    got = thealth.index_health(thealth.IndexProbe(**probe))
    want = jhealth.index_health(jhealth.IndexProbe(**probe))
    assert got["status"] == want["status"]
    assert {k: v["status"] for k, v in got["checks"].items()} == \
        {k: v["status"] for k, v in want["checks"].items()}
    for fn in ("perf_check", "slo_check"):
        for arg in (None, {}, {"active_regressions": ["a/b1/cuda"]},
                    {"exhausted": ["p99"], "alerting": []}):
            assert getattr(thealth, fn)(arg)["status"] == getattr(jhealth, fn)(arg)["status"]
    snap = {"limit_bytes": 100, "reserved_bytes": 99}
    assert thealth.budget_check(snap)["status"] == jhealth.budget_check(snap)["status"]


def test_perf_ledger_accounting_and_trips_match_raft_tpu():
    """The same device-time stream (steady, then 3x slower) through both
    ledgers on private buses: equal totals, hotspots and regression
    trips."""
    seen = {}
    out = {}
    for tag, mod, ev in (("t", tperf, tevents), ("j", jperf, jevents)):
        bus = ev.EventBus()
        seen[tag] = []
        bus.subscribe(lambda e, s=seen[tag]: s.append(e.fields["bucket"]),
                      kinds=frozenset({"perf_regression"}))
        old = ev._default
        ev._default = bus
        try:
            led = mod.PerfLedger(alpha=0.5, regression_x=1.5, min_samples=4, debounce_s=60.0)
            for i in range(12):
                led.record(index="a", backend="ivf_flat", bucket=8, kernel_path="cuda",
                           version="1", device_s=1e-3 if i < 6 else 3e-3, rows=5,
                           padded_rows=8)
            led.record(index="a", backend="ivf_flat", bucket=1, kernel_path="cuda",
                       version="1", device_s=2e-4, rows=1, padded_rows=1)
            hot = led.top_hotspots()
            out[tag] = (led.totals(), [{k: h[k] for k in ("bucket", "device_s", "dispatches",
                                                           "rows", "wasted_frac", "regressions")}
                                       for h in hot], led.health_slice())
        finally:
            ev._default = old
    assert out["t"] == out["j"]
    assert seen["t"] == seen["j"] == [8]


def test_tail_sampler_and_archive_match_raft_tpu():
    lat = np.random.default_rng(6).random(200) * 0.05
    got, want = texplain.TailSampler(per_window=3), jexplain.TailSampler(per_window=3)
    got.note_alarm(2.0)
    want.note_alarm(2.0)
    for i, l in enumerate(lat):
        now = i * 0.05
        assert got.reasons(latency_s=float(l), now=now) == want.reasons(latency_s=float(l),
                                                                          now=now)
    plan = texplain.build_plan(_records()[0], _records()[0]["requests"][0], "deep")
    jplan = jexplain.build_plan(_records()[0], _records()[0]["requests"][0], "deep")
    assert plan.to_dict() == jplan.to_dict()
    assert texplain.summary_line({"kernel_path": "cuda", "page": {"hits": 3, "misses": 1}}) == \
        jexplain.summary_line({"kernel_path": "cuda", "page": {"hits": 3, "misses": 1}})


def test_incident_correlation_matches_raft_tpu():
    """One trigger, context inside the window, a recovery, then quiet:
    both managers open one incident with the same timeline and close it
    "recovered" on the same synthetic clock."""
    out = {}
    for tag, mod, ev in (("t", tincidents, tevents), ("j", jincidents, jevents)):
        bus = ev.EventBus()
        mgr = mod.IncidentManager(bus, window_s=5.0, autoclose_s=30.0, max_open=2)
        bus.publish("registry_swap", index="a", version=2, prev_version=1)   # no incident
        bus.publish("batch_error", "batch_exception", index="a", bucket=8)
        bus.publish("compaction_promote", index="a", old_version=2, version=3)
        bus.publish("health_edge", "health_recovered", recovered=True, status="OK")
        opened = mgr.open_incidents()
        closed = mgr.poll(now=time.monotonic() + 60.0)
        out[tag] = ([e["kind"] for e in opened[0].timeline], len(opened),
                    [c.resolution for c in closed])
    assert out["t"] == out["j"] == (["batch_error", "compaction_promote", "health_edge"], 1,
                                    ["recovered"])


def test_profiler_wrappers_write_traces(tmp_path, monkeypatch):
    with tprofiler.profile(str(tmp_path / "p")):
        torch.ones(4) + 1
    assert os.path.exists(tmp_path / "p" / "trace.json")
    monkeypatch.setenv("RAFT_TPU_DISABLE_PROFILER", "1")
    assert tprofiler.capture_async(str(tmp_path), duration_s=0.01) is None
    monkeypatch.delenv("RAFT_TPU_DISABLE_PROFILER")
    info = tprofiler.capture_async(str(tmp_path / "c"), duration_s=0.01, reason="perf x")
    assert info is not None and tprofiler.last_capture()["path"] == info["path"]
    assert info["path"].endswith(f"profile_perf_x_{os.getpid()}")
    tprofiler.reset()
    assert tprofiler.last_capture() is None
