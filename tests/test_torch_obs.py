"""Port parity: the observability substrate of ``raft_tpu_torch`` against
raft_tpu's — the same registry operations give the same Prometheus,
OpenMetrics and JSON text; spans nest per thread under raft_tpu's names;
the slow-query log and the event bus behave alike; the per-version gauges
on a stub registry; the pager's counters and thrash event; device events
attributed to the open span; and the cost of one call from its kernels'
notes."""

import copy
import json
import os
import stat
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raft_tpu.obs import cost as jcost
from raft_tpu.obs import events as jevents
from raft_tpu.obs import export as jexport
import raft_tpu.obs.registry  # noqa: F401  (the package rebinds `registry` to a function)
from raft_tpu.obs import slowlog as jslowlog
from raft_tpu.obs import spans as jspans
from raft_tpu_torch import kernels, obs
from raft_tpu_torch.core import trace
from raft_tpu_torch.core.resources import Resources, to_device
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.obs import cost as tcost
from raft_tpu_torch.obs import device_events, events as tevents
from raft_tpu_torch.obs import export as texport
import raft_tpu_torch.obs.registry  # noqa: F401
from raft_tpu_torch.obs import slowlog as tslowlog
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.ops import cost as ops_cost
from raft_tpu_torch.store import MemoryBudget, paginate_index

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
jregistry = sys.modules["raft_tpu.obs.registry"]
tregistry = sys.modules["raft_tpu_torch.obs.registry"]


def _script(reg):
    """One sequence of counter / gauge / histogram operations."""
    c = reg.counter("raft_tpu_requests_total", help="requests")
    c.inc(index="a")
    c.inc(2.5, index="b")
    g = reg.gauge("raft_tpu_queue_depth", help='depth "now"\nline')
    g.set(7, index="a")
    g.inc(-2, index="a")
    h = reg.histogram("raft_tpu_latency_seconds", help="latency")
    for i, v in enumerate((3e-5, 1e-4, 0.02, 0.02, 75.0, 1e-3)):
        h.observe(v, exemplar=f"req-{i}", span="search")
    reg.histogram("raft_tpu_small", buckets=(0.1, 1.0)).observe(0.5)
    reg.counter("raft_tpu_bare").inc()
    with pytest.raises(ValueError):
        c.inc(-1)
    capped = type(reg)(max_series=2)
    capped.counter("x").inc(a="1")
    capped.counter("x").inc(a="2")
    with pytest.raises(Exception, match="label"):
        capped.counter("x").inc(a="3")


def test_same_operations_give_identical_exports():
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    _script(treg)
    _script(jreg)
    assert texport.to_prometheus(treg) == jexport.to_prometheus(jreg)
    assert texport.to_openmetrics(treg) == jexport.to_openmetrics(jreg)
    assert texport.snapshot_json(treg) == jexport.snapshot_json(jreg)
    for accept in (None, "application/openmetrics-text;q=0.9, text/plain;q=0.5",
                   "text/plain", "application/openmetrics-text;q=bad"):
        assert texport.negotiate_content_type(accept) == jexport.negotiate_content_type(accept)
    assert tregistry.DEFAULT_BUCKETS == jregistry.DEFAULT_BUCKETS


def test_spans_nest_per_thread_under_raft_names():
    tspans.clear_recent()
    got = {}

    def work(tag):
        with trace.trace_range(f"outer.{tag}") as outer:
            with trace.trace_range("inner") as inner:
                inner.add_stage("dispatch", 0.001)
                inner.add_event("transfers", 2)
                got[tag] = (outer.span_id, inner.parent_id, tspans.current_span() is inner)
        got[tag] += (tspans.current_span(),)

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for tag in ("a", "b"):
        outer_id, parent_of_inner, inner_current, after = got[tag]
        assert parent_of_inner == outer_id and inner_current and after is None
    roots = {s["name"]: s for s in tspans.recent_spans(10)}
    assert set(roots) >= {"outer.a", "outer.b"}
    assert roots["outer.a"]["events"] == {"transfers": 2.0}     # rolled up to the root
    assert set(roots["outer.a"]) == set(jspans.Span("x", 1, None).to_dict())
    series = dict(tregistry.default_registry().histogram("raft_tpu_span_seconds").collect())
    assert (("span", "inner"),) in series and (("span", "outer.a"),) in series
    tspans.set_enabled(False)
    try:
        with trace.trace_range("off") as sp:
            assert sp is None
    finally:
        tspans.set_enabled(True)


def test_slowlog_and_event_bus_match_raft():
    """The same script through both packages' slow-query logs and private
    buses: the same entries and deliveries (times aside)."""
    def slow(spans_mod, slowlog_mod):
        slowlog_mod.clear()
        slowlog_mod.configure(100.0)
        out = []
        for i, dur in enumerate((0.05, 0.2, 0.15)):
            sp = spans_mod.Span("serve.batch", 10 + i, None)
            sp.t_end = sp.t_start + dur
            sp.add_stage("queue", dur / 2)
            out.append(slowlog_mod.maybe_record(sp, detail={"kernel_path": "x"}))
        with pytest.raises(ValueError):
            slowlog_mod.configure(-1)
        entries = [{k: v for k, v in e.items() if k not in ("unix_time", "duration_ms")}
                   for e in slowlog_mod.entries()]
        slowlog_mod.configure(250.0)
        return out, entries

    assert slow(tspans, tslowlog) == slow(jspans, jslowlog)

    def bus(mod):
        b = mod.EventBus(ring=3)
        seen = []
        b.subscribe(lambda e: seen.append((e.kind, e.reason, e.seq, e.recovered, e.fields)),
                    kinds=frozenset({"page_thrash", "registry_swap"}), debounce_s=60.0,
                    name="t")
        b.subscribe(lambda e: 1 / 0, name="broken")
        for kind, reason in (("page_thrash", "p"), ("page_thrash", "p"), ("page_thrash", "q"),
                             ("registry_swap", None), ("health_edge", "h")):
            b.publish(kind, reason, index="i")
        with pytest.raises(ValueError, match="unknown event kind"):
            b.publish("nope")
        snap = b.snapshot()
        recent = [{k: v for k, v in e.items() if k not in ("t", "unix_time")}
                  for e in snap.pop("recent")]
        return seen, snap, recent, [e.kind for e in b.recent("page_thrash")]

    assert bus(tevents) == bus(jevents)
    assert tevents.KINDS == jevents.KINDS and tevents.TRIGGER_KINDS == jevents.TRIGGER_KINDS


class _Tiered:
    nbytes = 4096

    def stats(self):
        return {"resident": 3, "host_only": 5}


class _Stub:
    """An index registry stub: two paged versions, one dense, one whose
    size read fails."""

    def __init__(self, versions):
        self.versions = versions

    def live_versions(self):
        return self.versions


def _stub_versions():
    paged = SimpleNamespace(index=SimpleNamespace(paged=_Tiered()))
    dense = SimpleNamespace(index=SimpleNamespace(paged=None), device_bytes=lambda: 1234)
    broken = SimpleNamespace(index=None, device_bytes=lambda: 1 / 0)
    return {("a", 1): paged, ("a", 2): paged, ("b", 7): dense, ("c", 1): broken}


def test_page_and_live_buffer_gauges_on_a_stub_registry():
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    for versions in (_stub_versions(), {("b", 7): _stub_versions()[("b", 7)]}):
        got = (tcost.refresh_page_gauges(_Stub(versions), treg),
               tcost.refresh_live_buffer_gauges(_Stub(versions), treg))
        want = (jcost.refresh_page_gauges(_Stub(versions), jreg),
                jcost.refresh_live_buffer_gauges(_Stub(versions), jreg))
        assert got == want
        assert texport.to_prometheus(treg) == jexport.to_prometheus(jreg)
    assert treg.gauge("raft_tpu_page_resident").series() == []    # retired with their versions


def test_page_counters_and_thrash_event_equal_the_store(tmp_path):
    """An IVF-Flat pool of a third of its pages serving two-query batches on
    the CPU: the registry's page counters of the store equal its own
    ``hits`` / ``misses`` / ``evictions``, and the thrash it counts is on
    the bus; the pager's entry points are traced."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    q = rng.normal(size=(40, 8)).astype(np.float32)
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=24, kmeans_n_iters=4), x, res=CPU)
    paged = copy.copy(index)
    ld = index.list_data
    pr = 16
    n_pages = ld.shape[0] * -(-ld.shape[1] // pr)
    page_bytes = pr * ld.shape[2] * ld.element_size()
    tevents.reset()
    thrash = []
    tevents.subscribe(thrash.append, kinds=frozenset({"page_thrash"}), name="test")
    tiered = paginate_index(paged, page_rows=pr, name="obs-test",
                            budget=MemoryBudget(n_pages // 3 * page_bytes + 4 * n_pages))
    reg = tregistry.default_registry()
    before = {k: reg.counter(f"raft_tpu_page_{k}_total").value(index="obs-test")
              for k in ("hits", "misses", "evictions")}
    sp = ivf_flat.SearchParams(n_probes=3)
    for s in range(0, 40, 2):
        ivf_flat.search(sp, paged, q[s:s + 2], 5, res=CPU)
    after = {k: reg.counter(f"raft_tpu_page_{k}_total").value(index="obs-test") - before[k]
             for k in ("hits", "misses", "evictions")}
    assert after == {"hits": tiered.hits, "misses": tiered.misses,
                     "evictions": tiered.evictions}
    assert tiered.evictions > 0 and tiered.thrash > 0 and len(thrash) == 1   # debounced
    assert thrash[0].fields["index"] == "obs-test"
    tiered.evict(1)
    labels = {t.__traced__ for t in (tiered.ensure_resident, tiered.prefetch, tiered.evict)}
    assert labels == {"store.pager.ensure", "store.pager.prefetch", "store.pager.evict"}
    series = dict(reg.histogram("raft_tpu_span_seconds").collect())
    assert (("span", "store.pager.ensure"),) in series and (("span", "store.pager.evict"),) in series
    tevents.reset()


def test_device_events_attribute_to_the_open_span(tmp_path, monkeypatch):
    """A kernel build faked on the CPU (an ``nvcc`` that only writes its
    outputs) counts one build per source under the enclosing span, and an
    up-to-date build counts none; copies count by direction, and a copy
    that stays on the host counts nothing."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && : > "$2"; shift; done\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    reg = tregistry.default_registry()
    builds = reg.counter("raft_tpu_kernel_builds_total")
    base = builds.value(span="test.build")
    with trace.trace_range("test.build") as sp:
        path = kernels.build()
        assert path.exists() and sp.events["kernel_builds"] == 2
        kernels.build()                      # up to date: no build
        assert sp.events["kernel_builds"] == 2 and sp.events["kernel_build_seconds"] > 0
    assert builds.value(span="test.build") - base == 2

    moved = reg.counter("raft_tpu_transfer_bytes_total")
    h2d = moved.value(direction="h2d")
    with trace.trace_range("test.copy") as sp:
        device_events.record_copy(torch.device("cpu"), torch.device("cuda"), 64)
        device_events.record_copy(torch.device("cuda"), torch.device("cpu"), 8)
        to_device(np.zeros(4, np.float32), torch.device("cpu"))      # host to host
        assert sp.events == {"transfers": 2.0, "transfer_bytes": 72.0}
    assert moved.value(direction="h2d") - h2d == 64
    assert reg.counter("raft_tpu_transfer_events_total").value(
        span="test.copy", direction="d2h") == 1
    with pytest.raises(ValueError, match="family"):
        device_events.record("compile")


def test_analyze_callable_sums_the_noted_work():
    """``analyze_callable`` is the sum of the notes of one call (a lazy note
    is evaluated only inside the capture), times a second call, and takes
    the roofline share; a call that notes nothing reports no work."""
    work = [ops_cost.select_k_work(100, 1000, 10), ops_cost.fused_knn_work(4, 1000, 16, 10)]

    def fn(x):
        ops_cost.note("select_k", work[0])
        ops_cost.note("fused_knn", lambda: work[1])
        return x + 1

    rep = tcost.analyze_callable(fn, torch.ones(8))
    assert rep.flops == sum(w.flops for w in work)
    assert rep.bytes_accessed == sum(w.bytes_accessed for w in work)
    assert rep.launches == 2 and rep.seconds > 0 and 0 < rep.utilization
    assert rep.argument_memory_bytes == 32 and rep.peak_memory_bytes is None
    reg = tregistry.MetricsRegistry()
    tcost.record_cost(rep, reg, index="x")
    assert reg.gauge("raft_tpu_kernel_flops").value(index="x") == rep.flops
    assert reg.gauge("raft_tpu_roofline_utilization").value(index="x") == rep.utilization
    quiet = tcost.analyze_callable(lambda x: x * 2, torch.ones(3))
    assert quiet.flops is None and quiet.utilization is None and quiet.launches == 0
    assert tcost.analyze_callable(lambda x: 1 / 0, 1) is None
    ops_cost.note("select_k", lambda: 1 / 0)     # outside a capture: never evaluated


def test_profiler_ranges_only_while_a_profiler_runs(tmp_path, monkeypatch):
    """``trace_range`` names its block on a running ``torch.profiler``
    capture (``raft_tpu.<name>``); ``profile(dir)`` writes a Chrome trace,
    and nothing under RAFT_TPU_DISABLE_PROFILER."""
    @trace.traced("test.traced")
    def f(x):
        return x + 1

    assert f.__traced__ == "test.traced" and not trace._profiler_active()
    with trace.profile(str(tmp_path / "p")):
        assert trace._profiler_active()
        f(torch.ones(2))
    doc = json.loads((tmp_path / "p" / "trace.json").read_text())
    assert any(e.get("name") == "raft_tpu.test.traced" for e in doc["traceEvents"])
    monkeypatch.setenv("RAFT_TPU_DISABLE_PROFILER", "1")
    with trace.profile(str(tmp_path / "q")):
        assert not trace._profiler_active()
    assert not os.path.exists(tmp_path / "q")


def test_obs_names_and_the_serving_layer_refused():
    obs.install()
    assert "spans" in obs.snapshot() and "events" in obs.snapshot()
    assert obs.registry() is tregistry.default_registry()
    # the serving observability is ported (flight, profile, the auditor,
    # the SLO engine, the autotuner, the gateway); XLA's listeners have no
    # counterpart
    assert obs.flight.default_recorder() is obs.default_recorder()
    assert callable(obs.profile)
    assert obs.QualityAuditor is obs.quality.QualityAuditor
    assert obs.SloEngine is obs.slo.SloEngine and obs.SloSpec is obs.slo.SloSpec
    assert obs.Autotuner is obs.autotune.Autotuner
    assert obs.OperationalGateway is obs.gateway.OperationalGateway
    with pytest.raises(NotImplementedError, match="obs.device_events"):
        obs.xla_events
    with pytest.raises(NotImplementedError, match="analyze_callable"):
        obs.analyze_compiled
    from raft_tpu_torch.core import logger, native

    assert logger.child("obs.slowlog").name == "raft_tpu_torch.obs.slowlog"
    # the native core's log bridge is served since slice 16, where a compiler is
    assert logger.bridge_native() is native.available()
