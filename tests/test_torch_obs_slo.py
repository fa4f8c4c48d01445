"""Port parity of ``obs.slo`` (the SLO engine) on the CPU.

Both packages' engines get the same specs, the same counter and histogram
series in their own registries (and the same recall / freshness sources),
and the same ``evaluate_once(now=)`` sequence on a synthetic clock: every
report, ``snapshot()``, ``health()``, ``paging()``, ``budget_remaining()``,
gauge and ``slo_burn`` event is equal (exactly: the same arithmetic),
through a healthy start, an outage whose burn latches, a spec added
mid-stream (its baseline primed at once) and a recovery that re-arms.
Then the service's ``slo=`` wiring: default objectives watched on
``add_index`` and dropped on ``remove_index``, a prebuilt engine adopted,
an exhausted budget folded into ``healthz()``.  No thread runs: engines
are driven with ``start=False`` / ``evaluate_once``."""

import os
import types

import numpy as np
import pytest
import torch

from raft_tpu.obs import events as jevents
from raft_tpu.obs import slo as jslo
from raft_tpu.obs.registry import MetricsRegistry as JRegistry
from raft_tpu_torch import serve
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.obs import events as tevents
from raft_tpu_torch.obs import health as thealth
from raft_tpu_torch.obs import slo as tslo
from raft_tpu_torch.obs.registry import MetricsRegistry as TRegistry

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


class _Sources:
    """The recall and freshness sources of a service, scripted."""

    def __init__(self):
        self.ewma = None
        self.age = 0.0
        self.auditor = types.SimpleNamespace(recall_ewma=lambda name: self.ewma)
        index = types.SimpleNamespace(backlog_age_s=lambda: self.age)
        self.registry = types.SimpleNamespace(get=lambda name: index)


def _specs(mod, index="a"):
    return [
        mod.SloSpec(f"{index}-availability", index, "availability", objective=0.999),
        mod.SloSpec(f"{index}-latency", index, "latency", objective=0.99, target=0.25),
        mod.SloSpec(f"{index}-recall", index, "recall", objective=0.9),
        mod.SloSpec(f"{index}-freshness", index, "freshness", objective=0.99, target=300.0),
    ]


def _feed(reg, rng_seed, n, err, slow, index="a"):
    """``n`` requests of which ``err`` failed and a ``slow`` share took 0.5 s."""
    rng = np.random.default_rng(rng_seed)
    reg.counter("raft_tpu_serve_requests_total").inc(float(n), index=index)
    if err:
        reg.counter("raft_tpu_serve_errors_total").inc(float(err), index=index, cause="device")
    hist = reg.histogram("raft_tpu_serve_request_seconds")
    for v in np.where(rng.random(n) < slow, 0.5, rng.uniform(0.001, 0.04, n)):
        hist.observe(float(v), index=index)


def _capture(events_mod):
    seen = []
    return seen, events_mod.subscribe(seen.append, kinds=frozenset({"slo_burn"}),
                                      name="slo-parity")


def test_engines_agree_through_burn_latch_and_recovery():
    jreg, treg = JRegistry(), TRegistry()
    jsrc, tsrc = _Sources(), _Sources()
    kw = dict(scale=1.0, eval_s=10.0, budget_window_s=6 * 3600.0)
    jeng = jslo.SloEngine(_specs(jslo), service=jsrc, registry=jreg, **kw)
    teng = tslo.SloEngine(_specs(tslo), service=tsrc, registry=treg, **kw)
    jseen, jsub = _capture(jevents)
    tseen, tsub = _capture(tevents)
    # (seconds since start, requests, errors, slow share, recall ewma, backlog age)
    script = ([(60.0 * i, 500, 0, 0.0, 0.97, 10.0) for i in range(1, 6)]
              + [(300.0 + 60.0 * i, 500, 200, 0.6, 0.5, 900.0) for i in range(1, 5)]
              + [(600.0 + 120.0 * i, 500, 0, 0.0, 0.97, 10.0) for i in range(1, 10)]
              + [(3 * 3600.0 + 600.0 * i, 500, 0, 0.0, 0.97, 10.0) for i in range(1, 4)])
    try:
        latched = recovered = False
        for step, (now, n, err, slow, ewma, age) in enumerate(script):
            for reg, src in ((jreg, jsrc), (treg, tsrc)):
                _feed(reg, step, n, err, slow)
                src.ewma, src.age = ewma, age
            if step == 7:       # a spec added mid-stream: its baseline is primed at once
                for mod, eng in ((jslo, jeng), (tslo, teng)):
                    eng.add_spec(mod.SloSpec("a-latency-tight", "a", "latency",
                                             objective=0.99, target=0.06))
            got = teng.evaluate_once(now=now)
            assert got == jeng.evaluate_once(now=now), step
            assert teng.snapshot() == jeng.snapshot()
            assert teng.health() == jeng.health() and teng.paging() == jeng.paging()
            for spec in jeng.specs():
                assert teng.budget_remaining(spec.name) == jeng.budget_remaining(spec.name)
            latched |= bool(teng.paging())
            recovered |= latched and not teng.paging()
        assert latched and recovered, "the script must latch a page and recover"
        assert teng.budget_remaining("nope") is None
        for name in ("raft_tpu_slo_budget_remaining", "raft_tpu_slo_burn_rate",
                     "raft_tpu_slo_alert"):
            assert treg.gauge(name).collect() == jreg.gauge(name).collect(), name
        strip = [(e.reason, e.recovered, dict(e.fields)) for e in jseen]
        assert [(e.reason, e.recovered, dict(e.fields)) for e in tseen] == strip
        assert any(r for _, r, _ in strip) and any(not r for _, r, _ in strip)
        teng.remove_spec("a-latency-tight")
        assert not [k for k in treg.gauge("raft_tpu_slo_alert").collect()
                    if ("slo", "a-latency-tight") in k]
        assert "slo" in treg.snapshot()
    finally:
        jsub.unsubscribe()
        tsub.unsubscribe()
        jeng.stop()
        teng.stop()
    assert "slo" not in treg.snapshot()


def test_default_specs_and_spec_checks_match(monkeypatch):
    for mod in (jslo, tslo):
        assert [p.__dict__ for p in mod.ALERT_POLICIES] == [p.__dict__ for p in jslo.ALERT_POLICIES]
    monkeypatch.setenv("RAFT_TPU_SLO_P99_MS", "40")
    monkeypatch.setenv("RAFT_TPU_SLO_RECALL", "0.8")
    assert ([s.__dict__ for s in tslo.default_specs("x")]
            == [s.__dict__ for s in jslo.default_specs("x")])
    for bad in (dict(kind="nope", objective=0.9), dict(kind="latency", objective=1.0)):
        for mod in (jslo, tslo):
            with pytest.raises(ValueError):
                mod.SloSpec("s", "x", **bad)
    monkeypatch.setenv("RAFT_TPU_SLO_WINDOW_SCALE", "0.001")
    monkeypatch.setenv("RAFT_TPU_SLO_EVAL_S", "5")
    eng = tslo.SloEngine(registry=TRegistry())
    try:
        snap = eng.snapshot()
        want = jslo.SloEngine(registry=JRegistry()).snapshot()
        assert snap == want and snap["eval_s"] == pytest.approx(0.005)
    finally:
        eng.stop()


def _index():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 20)).astype(np.float32)
    return tflat.build(tflat.IndexParams(n_lists=4), x, res=CPU), x


def test_service_watches_default_specs_and_folds_exhausted_budget():
    index, x = _index()
    svc = serve.SearchService(k=5, max_batch=4, slo=True, start=False)
    try:
        assert svc.slo_engine is not None and svc.slo_engine.specs() == []
        svc.add_index("s", serve.MutableIndex(index))
        assert [s.name for s in svc.slo_engine.specs()] == [
            "s-availability", "s-latency", "s-recall", "s-freshness"]
        eng = svc.slo_engine
        st = eng._states["s-availability"]
        # an exhausted availability budget: DEGRADED, named under slo
        st.budget_remaining = -0.5
        report = svc.healthz()
        assert report["status"] == thealth.DEGRADED
        assert "s-availability" in report["slo"]["detail"]
        assert "slo" in svc.metrics() and svc._incident_context()["slo"]["exhausted"]
        svc.remove_index("s")
        assert eng.specs() == []
    finally:
        svc.stop()
    engine = tslo.SloEngine(_specs(tslo, "b"), registry=TRegistry())
    svc = serve.SearchService(k=5, max_batch=4, slo=engine, start=False)
    try:
        assert svc.slo_engine is engine
        svc.add_index("b", serve.MutableIndex(index))
        assert len(engine.specs()) == 4, "an adopted engine keeps exactly its own specs"
    finally:
        svc.stop()
    svc = serve.SearchService(k=5, max_batch=4, slo=_specs(tslo, "c")[:2], start=False)
    try:
        assert [s.name for s in svc.slo_engine.specs()] == ["c-availability", "c-latency"]
    finally:
        svc.stop()
