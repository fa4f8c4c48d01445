"""Port parity of ``obs.gateway`` (the operational HTTP server) and the
service with all four obs layers on, on the CPU.

``dispatch()`` on every route of a port service and of a raft_tpu service,
both serving one saved IVF-Flat index with the same layers, gives the same
status codes and the same JSON keys (a route's body is what that package's
pull API returns).  One test goes through a real socket on 127.0.0.1 at
port 0: ``/metrics`` content negotiation, ``/healthz`` 200 / 503 as
``healthz()`` says, the admin plane 404 when off, 403 on without a token,
401 without or with a wrong token, 200 with it.  A service with the
auditor, ``slo=True``, ``autotune=True`` and a gateway serves, mutates and
reports the new sections, and ``stop()`` joins every thread the layers
started.  Every server is closed in ``finally``; no test reads the clock
against a bound."""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.obs import export as texport
from raft_tpu_torch.obs import gateway as tgateway
from raft_tpu_torch.obs import health as thealth

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
N, D, K = 400, 12, 5
TOKEN = "s3cret"
WAIT_S = 120


@pytest.fixture(autouse=True)
def _dumps_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FLIGHT_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((8, D)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("g") / "flat.idx")
    jflat.save(path, jflat.build(jflat.IndexParams(n_lists=8, kmeans_n_iters=5), x))
    return path, q


def _service(pkg, flat, obs, path, **kw):
    index = flat.load(path, res=CPU) if pkg is tserve else flat.load(path)
    svc = pkg.SearchService(
        k=K, max_batch=8, max_delay_ms=0.5, compaction=True,
        auditor=obs.QualityAuditor(k=K, sampling=1.0),
        slo=True, autotune=obs.Autotuner(eval_s=3600.0),
        gateway=obs.GatewayConfig(admin=True, token=TOKEN), **kw)
    svc.add_index("g", pkg.MutableIndex(index, search_params=flat.SearchParams(n_probes=4)),
                  warmup=True)
    return svc


def _stop(svc):
    auditor = svc.auditor
    svc.stop()
    if auditor is not None:
        auditor.stop()


#: (method, path, query, authorised): every route, the admin plane with and
#: without the bearer token, and the error paths
REQUESTS = (
    ("GET", "/metrics", {}, False), ("GET", "/healthz", {}, False),
    ("GET", "/readyz", {}, False), ("GET", "/snapshot", {}, False),
    ("GET", "/slo", {}, False), ("GET", "/perf/hotspots", {"n": "3"}, False),
    ("GET", "/perf/hotspots", {"n": "x"}, False), ("GET", "/incidents", {}, False),
    ("GET", "/incidents/9999", {}, False), ("GET", "/flight", {}, False),
    ("GET", "/explain", {"name": "g"}, False), ("GET", "/explain", {"name": "nope", "q": "1"}, False),
    ("GET", "/explain", {"name": "g", "q": "a,b"}, False), ("GET", "/autotune", {}, False),
    ("POST", "/metrics", {}, False), ("GET", "/nowhere", {}, False),
    ("POST", "/admin/effort_pin", {"name": "g", "level": "1"}, False),
    ("POST", "/admin/effort_pin", {"name": "g", "level": "1"}, True),
    ("POST", "/admin/effort_pin", {"name": "g", "level": "x"}, True),
    ("POST", "/admin/effort_pin", {"name": "g", "level": "-1"}, True),
    ("POST", "/admin/effort_pin", {"name": "nope", "level": "1"}, True),
    ("POST", "/admin/compact", {}, True), ("POST", "/admin/compact", {"name": "g"}, False),
    ("POST", "/admin/compact", {"name": "g"}, True), ("GET", "/admin/compact", {}, True),
    ("POST", "/admin/flight_dump", {}, True), ("POST", "/admin/archive_dump", {}, True),
)


def test_dispatch_matches_raft_tpu_on_every_route(saved):
    path, q = saved
    j = _service(jserve, jflat, jobs, path)
    t = _service(tserve, tflat, tobs, path)
    try:
        for svc in (j, t):
            for i in range(q.shape[0]):
                svc.search("g", q[i], timeout=WAIT_S)
            svc.auditor.flush(WAIT_S)
            svc.slo_engine.evaluate_once()
            svc.autotuner.evaluate_once()
        vec = ",".join(f"{v:.4f}" for v in q[0])
        for method, route, query, auth in REQUESTS + (("GET", "/explain", {"name": "g", "q": vec},
                                                        False),):
            headers = {"Authorization": f"Bearer {TOKEN}"} if auth else {}
            js, jct, jbody, jextra = j.gateway.dispatch(method, route, dict(query), headers)
            ts, tct, tbody, textra = t.gateway.dispatch(method, route, dict(query), headers)
            assert (ts, tct) == (js, jct), (method, route, query, tbody[:300])
            assert (textra or {}).keys() == (jextra or {}).keys()
            if route == "/metrics" and ts == 200:
                assert b"raft_tpu_recall_ewma{" in tbody, tbody[-2000:]
                assert b"raft_tpu_autotune_level{" in tbody
                continue
            jdoc, tdoc = json.loads(jbody), json.loads(tbody)
            assert set(tdoc) == set(jdoc), (method, route, set(tdoc) ^ set(jdoc))
        # the gateway counts every answer by route pattern and code
        counts = tobs.default_registry().counter("raft_tpu_gateway_requests_total").collect()
        assert counts[(("code", "404"), ("route", "unknown"))] >= 1
        assert counts[(("code", "401"), ("route", "/admin/effort_pin"))] >= 1
    finally:
        _stop(j)
        _stop(t)


def _request(url, path, *, method="GET", headers=None):
    req = urllib.request.Request(url + path, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def test_socket_probes_negotiation_and_admin_auth(saved):
    path, q = saved
    svc = _service(tserve, tflat, tobs, path)
    off = tgateway.OperationalGateway(svc, config=tgateway.GatewayConfig(port=0))
    no_token = tgateway.OperationalGateway(svc, config=tgateway.GatewayConfig(admin=True))
    try:
        off.start()
        no_token.start()
        url = svc.gateway.url
        assert url.startswith("http://127.0.0.1:") and svc.gateway.port > 0
        status, ctype, body = _request(url, "/metrics")
        assert status == 200 and ctype == texport.PROMETHEUS_CONTENT_TYPE
        status, ctype, body = _request(url, "/metrics", headers={
            "Accept": "application/openmetrics-text; version=1.0.0"})
        assert status == 200 and ctype == texport.OPENMETRICS_CONTENT_TYPE
        assert body.rstrip().endswith(b"# EOF")
        status, _, body = _request(url, "/healthz")
        assert status == 200 and json.loads(body)["status"] == svc.healthz()["status"]
        assert _request(url, "/readyz")[0] == 200
        # a served version whose answers are all wrong: recall EWMA 0, UNHEALTHY, 503
        index, version = svc.registry.get_versioned("g")
        svc.auditor.observe("g", version, index, q, np.full((q.shape[0], K), 10 ** 6))
        svc.auditor.flush(WAIT_S)
        assert svc.healthz()["status"] == thealth.UNHEALTHY
        status, _, body = _request(url, "/healthz")
        assert status == 503 and json.loads(body)["status"] == thealth.UNHEALTHY
        pin = "/admin/effort_pin?name=g&level=1"
        assert _request(off.url, pin, method="POST")[0] == 404
        assert _request(no_token.url, pin, method="POST",
                        headers={"Authorization": f"Bearer {TOKEN}"})[0] == 403
        status, _, _ = _request(url, pin, method="POST")
        assert status == 401
        assert _request(url, pin, method="POST", headers={"Authorization": "Bearer nope"})[0] == 401
        status, _, body = _request(url, pin, method="POST",
                                   headers={"Authorization": f"Bearer {TOKEN}"})
        assert status == 200 and json.loads(body)["pinned"] == 1
        assert svc.effort_arbiter("g").effective_level() == 1
        status, _, body = _request(url, "/admin/compact?name=g", method="POST",
                                   headers={"Authorization": f"Bearer {TOKEN}"})
        assert status == 200 and "status" in json.loads(body)
    finally:
        off.close()
        no_token.close()
        _stop(svc)
    assert svc.gateway.port is None, "stop() closes the owned gateway"


def test_standalone_main_serves_and_drains():
    seen = {}

    def ready(gateway, stop):
        seen["health"] = _request(gateway.url, "/healthz")[0]
        seen["ready"] = _request(gateway.url, "/readyz")[0]
        seen["explain"] = _request(gateway.url, "/explain?name=a&q=1")[0]
        stop.set()

    out = {}
    worker = threading.Thread(target=lambda: out.setdefault(
        "rc", tgateway.main(["--port", "0"], ready=ready)))
    worker.start()
    worker.join(WAIT_S)
    assert not worker.is_alive() and out["rc"] == 0
    assert seen == {"health": 200, "ready": 503, "explain": 404}
    with tgateway.OperationalGateway(config=tgateway.GatewayConfig(port=0)) as gw:
        taken = gw.port
        assert tgateway.main(["--port", str(taken)]) == 1, "a port in use exits 1"


def _threads():
    return {t.ident for t in threading.enumerate()}


def test_service_with_every_layer_serves_mutates_and_stops(saved, monkeypatch):
    path, q = saved
    monkeypatch.setenv("RAFT_TPU_GATEWAY", "1")
    monkeypatch.setenv("RAFT_TPU_SLO_EVAL_S", "0.05")
    monkeypatch.setenv("RAFT_TPU_AUTOTUNE_EVAL_S", "0.05")
    before = _threads()
    auditor = tobs.QualityAuditor(k=K, sampling=1.0)
    svc = tserve.SearchService(k=K, max_batch=8, max_delay_ms=0.5, auditor=auditor, slo=True,
                               autotune=True, gateway=None)
    try:
        assert svc.gateway is not None and svc.gateway.port > 0
        index = tflat.load(path, res=CPU)
        svc.add_index("m", tserve.MutableIndex(index, search_params=tflat.SearchParams(n_probes=8)),
                      warmup=True)
        mi = svc.get("m")
        ids = mi.upsert(q[:4] + 100.0)
        mi.delete(np.arange(0, 40))
        for i in range(q.shape[0]):
            d, got = svc.search("m", q[i] + (100.0 if i < 4 else 0.0), timeout=WAIT_S)
            if i < 4:
                assert got[0] == ids[i]
            assert not np.isin(got, np.arange(0, 40)).any()
        assert auditor.flush(WAIT_S)
        st = svc.stats("m")
        assert st["autotune_level"] == 0 and st["side_rows"] == 4
        hz = svc.healthz()
        checks = hz["indexes"]["m"]["checks"]
        assert checks["recall"]["status"] == thealth.OK and "autotune" in checks
        assert hz["slo"]["status"] == thealth.OK
        snap = svc.metrics()
        assert {"slo", "indexes", "health", "registry", "perf"} <= set(snap)
        reg = snap["registry"]
        assert reg["quality"]["indexes"]["m"]["audits"] == q.shape[0]
        assert "m" in reg["autotune"]["indexes"] and "m-latency" in reg["slo"]["specs"]
        assert _request(svc.gateway.url, "/autotune")[0] == 200
    finally:
        _stop(svc)
    leftover = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
    assert not leftover, [t.name for t in leftover]


def test_incident_route_finds_an_incident_by_its_id():
    """``/incidents/<id>`` answers an incident the manager holds.  Ids are
    ints and the path's is text; raft_tpu compares the two as they are, so
    its route answers 404 for every incident: the port compares the text."""
    from raft_tpu_torch.obs import events as tevents
    from raft_tpu_torch.obs import incidents as tincidents

    tevents.publish("batch_error", "gateway_route_probe", index="probe")
    held = tincidents.default_manager().open_incidents() + \
        tincidents.default_manager().closed_incidents()
    assert held
    gw = tgateway.OperationalGateway(config=tgateway.GatewayConfig())
    status, _, body, _ = gw.dispatch("GET", f"/incidents/{held[-1].id}", {}, {})
    assert status == 200 and json.loads(body)["id"] == held[-1].id
    assert gw.dispatch("GET", "/incidents/not-an-id", {}, {})[0] == 404
