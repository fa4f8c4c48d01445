"""Port parity of ``obs.autotune`` (the closed-loop effort controller), the
frontier sweep (``bench.frontier``) and ``bench.plot`` on the CPU.

``pareto``, ``FrontierModel.predict`` and ``bench.plot``'s filters equal
raft_tpu's; a model file written by either package loads in the other with
equal points.  Two controllers, one per package, each over its own
``EffortArbiter`` and the same stub auditor / SLO taps, walk the same
levels for the same reasons over one scripted clock (recall floor up, p99
burn down after ``degrade_ticks``, back to the frontier optimum after
``restore_ticks``), with equal events, gauges, snapshots and health.  The
sweep's grid and its model fold equal raft_tpu's; ``python -m
raft_tpu_torch.bench frontier --platform cpu`` writes a model raft_tpu
reads; a killed sweep resumes from its ``.partial``; ``--sharded`` raises
naming ROADMAP Queue 1 item 7.  Then the service's ``autotune=`` wiring.
Every controller is driven by ``step(now=)``: no tick thread runs."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raft_tpu.bench import frontier as jfrontier
from raft_tpu.bench import plot as jplot
from raft_tpu.bench import runner as jrunner
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.obs import autotune as jauto
from raft_tpu.obs import events as jevents
from raft_tpu.obs.registry import MetricsRegistry as JRegistry
from raft_tpu.serve.effort import EffortArbiter as JArbiter
from raft_tpu_torch import serve
from raft_tpu_torch.bench import frontier as tfrontier
from raft_tpu_torch.bench import plot as tplot
from raft_tpu_torch.bench import runner as trunner
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.obs import autotune as tauto
from raft_tpu_torch.obs import events as tevents
from raft_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from raft_tpu_torch.serve.effort import EffortArbiter as TArbiter

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _points(mod, rng):
    return [mod.FrontierPoint(effort={"n_probes": int(p), "refine_ratio": int(r)},
                              qps=float(q), recall=float(rc))
            for p, r, q, rc in zip(rng.integers(1, 64, 30), rng.integers(1, 3, 30),
                                   rng.uniform(10, 1000, 30), np.round(rng.random(30), 2))]


def test_pareto_predict_and_plot_filters_match():
    rng = np.random.default_rng(1)
    jp, tp = _points(jauto, rng), _points(tauto, np.random.default_rng(1))
    assert [p.to_dict() for p in tauto.pareto(tp)] == [p.to_dict() for p in jauto.pareto(jp)]
    jm, tm = jauto.FrontierModel(), tauto.FrontierModel()
    for j, t in zip(jp, tp):
        jm.add("ivf_flat", j)
        tm.add("ivf_flat", t)
    for effort in ({"n_probes": 8}, {"n_probes": 28, "refine_ratio": 2}, {"n_probes": 1},
                   {}, {"lut_dtype": "bfloat16"}):
        want = jm.predict("ivf_flat", effort)
        got = tm.predict("ivf_flat", effort)
        assert got.to_dict() == want.to_dict(), effort
    assert tm.predict("cagra", {"itopk_size": 64}) is None
    pts = [(float(r), float(q)) for r, q in zip(np.round(rng.random(40), 2), rng.uniform(1, 99, 40))]
    assert tplot.pareto_frontier(pts) == jplot.pareto_frontier(pts)
    results = [(a, r, q) for a, (r, q) in zip(("x", "y") * 20, pts)]
    jr = [jrunner.RunResult(a, "d", 10, {}, {}, 0.0, q, 1.0, r, 1.0) for a, r, q in results]
    tr = [trunner.RunResult(a, "d", 10, {}, {}, 0.0, q, 1.0, r, 1.0) for a, r, q in results]
    assert tplot.group_frontiers(tr) == jplot.group_frontiers(jr)


def test_plot_writes_png_and_needs_matplotlib(tmp_path, monkeypatch):
    rs = [trunner.RunResult("a", "d", 10, {}, {}, 0.0, q, 1.0, r, 1.0)
          for r, q in ((0.5, 900.0), (0.9, 300.0), (0.99, 80.0))]
    path = str(tmp_path / "f.png")
    tplot.plot_results(rs, path, title="t")
    assert os.path.getsize(path) > 0
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(ImportError):
        tplot.plot_results(rs, str(tmp_path / "g.png"))


def test_model_files_load_in_both_packages(tmp_path):
    rng = np.random.default_rng(2)
    tm = tauto.FrontierModel(meta={"dataset": "unit", "k": 10, "platform": "cuda"})
    for p in _points(tauto, rng)[:6]:
        tm.add("ivf_flat", p)
    tm.add("cagra", tauto.FrontierPoint({"itopk_size": 32, "search_width": 1}, 500.0, 0.93,
                                        device_s_per_query=1.5e-5))
    tm.pareto_filter()
    path = str(tmp_path / "t.json")
    tm.save(path)
    jm = jauto.FrontierModel.load(path)
    assert jm.to_dict() == tm.to_dict()
    jm.save(str(tmp_path / "j.json"))
    back = tauto.FrontierModel.load(str(tmp_path / "j.json"))
    assert back.to_dict() == tm.to_dict() and back.backends() == ["cagra", "ivf_flat"]
    assert json.load(open(path))["schema"] == "raft_tpu.frontier"
    with pytest.raises(ValueError, match="not a raft_tpu.frontier"):
        tauto.FrontierModel.from_dict({"schema": "other"})
    doc = tm.to_dict()
    doc["schema_version"] = 99
    with pytest.raises(ValueError, match="newer than this reader"):
        tauto.FrontierModel.from_dict(doc)


class _Slo:
    def __init__(self):
        self.paging_specs = []

    def paging(self):
        return list(self.paging_specs)

    def health(self):
        return {"exhausted": [], "alerting": list(self.paging_specs)}


class _Auditor:
    ewma = None

    def recall_ewma(self, name):
        return self.ewma


class _Perf:
    def totals(self):
        return {"t": {"device_s": 0.5, "rows": 1000}}


def _controller(mod, arb_cls, flat, frontier, reg):
    tuner = mod.Autotuner(eval_s=3600.0, recall_floor=0.9, degrade_ticks=2, restore_ticks=3,
                          frontier=frontier, registry=reg)
    arb = arb_cls(None, max_level=3, name="t")
    slo, auditor = _Slo(), _Auditor()
    index = SimpleNamespace(search_params=flat.SearchParams(n_probes=32), kind="ivf_flat")
    tuner.watch_index("t", arb, index=index, auditor=auditor, slo=slo, perf=_Perf())
    return tuner, arb, slo, auditor


@pytest.mark.parametrize("with_frontier", [False, True])
def test_controllers_walk_the_same_levels(with_frontier):
    frontiers = []
    for mod in (jauto, tauto):
        model = None
        if with_frontier:
            model = mod.FrontierModel(meta={"dataset": "unit"})
            for probes, recall, qps in ((32, 0.99, 100.0), (16, 0.96, 180.0), (8, 0.93, 300.0),
                                        (4, 0.85, 500.0)):
                model.add("ivf_flat", mod.FrontierPoint({"n_probes": probes}, qps, recall))
        frontiers.append(model)
    jreg, treg = JRegistry(), TRegistry()
    jt, ja, jslo, jaud = _controller(jauto, JArbiter, jflat, frontiers[0], jreg)
    tt, ta, tslo, taud = _controller(tauto, TArbiter, tflat, frontiers[1], treg)
    seen = {"j": [], "t": []}
    jsub = jevents.subscribe(seen["j"].append, kinds=frozenset({"autotune_step"}), name="at")
    tsub = tevents.subscribe(seen["t"].append, kinds=frozenset({"autotune_step"}), name="at")
    # (recall ewma, p99 paging): calm, a burn, recall under the floor while
    # burning, calm again for long enough to settle, a burn at the optimum
    script = ([(0.97, False)] * 4 + [(0.97, True)] * 5 + [(0.85, True)] * 2
              + [(0.97, False)] * 12 + [(None, True)] * 4 + [(0.97, False)] * 4)
    try:
        levels = []
        for tick, (ewma, burning) in enumerate(script):
            for slo, aud in ((jslo, jaud), (tslo, taud)):
                slo.paging_specs = ["t-latency"] if burning else []
                aud.ewma = ewma
            want = jt.step("t", now=float(tick))
            assert tt.step("t", now=float(tick)) == want, tick
            assert tt.health() == jt.health() and tt.snapshot() == jt.snapshot()
            levels.append(want)
        assert len(set(levels)) > 1, levels
        strip = [(e.recovered, dict(e.fields)) for e in seen["j"]]
        assert [(e.recovered, dict(e.fields)) for e in seen["t"]] == strip
        reasons = {f["step_reason"] for _, f in strip}
        assert {"p99_burn", "recall_floor", "frontier_optimum"} <= reasons, reasons
        for name in ("raft_tpu_autotune_level", "raft_tpu_autotune_recall_floor_margin",
                     "raft_tpu_autotune_predicted_qps"):
            assert treg.gauge(name).collect() == jreg.gauge(name).collect(), name
        assert tt.level("t") == jt.level("t") and tt.level("nope") is None
        tt.unwatch_index("t")
        assert not treg.gauge("raft_tpu_autotune_level").collect()
    finally:
        jsub.unsubscribe()
        tsub.unsubscribe()
        jt.stop()
        tt.stop()
    assert "autotune" not in treg.snapshot()


def test_frontier_path_env_loads_the_model(tmp_path, monkeypatch):
    model = tauto.FrontierModel(meta={"n": 1})
    model.add("ivf_flat", tauto.FrontierPoint({"n_probes": 8}, 100.0, 0.95))
    path = model.save(str(tmp_path / "m.json"))
    monkeypatch.setenv("RAFT_TPU_FRONTIER_PATH", path)
    tuner = tauto.Autotuner(registry=TRegistry())
    try:
        assert tuner.frontier.to_dict() == model.to_dict()
        assert tuner.snapshot()["frontier_loaded"] is True
    finally:
        tuner.stop()


def test_grids_and_model_fold_match():
    for n, dim, metric, comp in ((100_000, 96, "inner_product", False),
                                 (2000, 16, "sqeuclidean", True),
                                 (50_000, 128, "inner_product", True)):
        assert (tfrontier.default_grids(n, dim, metric, comparators=comp)
                == jfrontier.default_grids(n, dim, metric, comparators=comp))
    assert tfrontier.SERVE_BACKENDS == jfrontier.SERVE_BACKENDS
    rng = np.random.default_rng(4)
    docs = []
    for algo, sp in (("raft_tpu_ivf_flat", {"n_probes": 4}), ("raft_tpu_ivf_flat", {"n_probes": 8}),
                     ("raft_tpu_ivf_pq", {"n_probes": 8, "refine_ratio": 2}),
                     ("raft_tpu_cagra", {"itopk_size": 32}), ("numpy_exact", {}),
                     ("raft_tpu_brute_force", {})):
        docs.append(dict(algo=algo, dataset="d", k=10, build_param={}, search_param=sp,
                         build_time_s=1.0, qps=float(rng.uniform(10, 1000)), latency_ms=1.0,
                         recall=float(rng.random()), end_to_end_s=1.0,
                         device_time_s=None if algo == "raft_tpu_cagra" else 0.01,
                         device_qps=None))
    meta = {"dataset": "d", "n": 5}
    want = jfrontier.frontier_model([jrunner.RunResult(**d) for d in docs], n_queries=50,
                                    meta=meta)
    got = tfrontier.frontier_model([trunner.RunResult(**d) for d in docs], n_queries=50,
                                   meta=meta)
    assert got.to_dict() == want.to_dict()
    assert got.points["cagra"][0].device_s_per_query is None


def test_cli_sweep_writes_a_model_raft_tpu_reads(tmp_path, monkeypatch):
    from raft_tpu_torch.bench.__main__ import main

    monkeypatch.chdir(tmp_path)
    out, sweep_out = str(tmp_path / "model.json"), str(tmp_path / "sweep.json")
    rc = main(["frontier", "--platform", "cpu", "--n", "2000", "--queries", "50",
               "--no-comparators", "--algos", "raft_tpu_ivf_flat", "--out", out,
               "--sweep-out", sweep_out])
    assert rc == 0
    model = jfrontier.FrontierModel.load(out)
    assert model.backends() == ["ivf_flat"] and model.meta["platform"] == "cpu"
    assert model.meta["n"] == 2000 and model.meta["k"] == 10
    for p in model.points["ivf_flat"]:
        assert 0.0 <= p.recall <= 1.0 and p.qps > 0 and p.device_s_per_query is None
        assert set(p.effort) == {"n_probes"}
    doc = json.load(open(sweep_out))
    assert len(doc["results"]) == 5 and list(doc["kernels"]) == ["raft_tpu_ivf_flat"]
    assert doc["kernels"]["raft_tpu_ivf_flat"] == {"kernel_path": "torch", "launches": {}}
    assert doc["frontiers"]["raft_tpu_ivf_flat"]
    record = json.load(open(sweep_out.replace(".json", "_record.json")))["record"]
    assert record["metric"] == "frontier_deep-image-96-inner_k10" and record["platform"] == "cpu"
    assert not os.path.exists(sweep_out + ".partial")
    assert not os.path.exists(tmp_path / "BENCH_last.json")


def test_killed_sweep_resumes_from_its_partial(tmp_path, monkeypatch):
    ds = tfrontier.make_dataset("unit", 1000, n_queries=20, k=5, dim=8, metric="sqeuclidean",
                                res=CPU)
    want = jfrontier.make_dataset("unit", 1000, n_queries=20, k=5, dim=8, metric="sqeuclidean")
    np.testing.assert_array_equal(ds.base, np.asarray(want.base))
    np.testing.assert_array_equal(ds.gt_neighbors, np.asarray(want.gt_neighbors))
    grids = [("raft_tpu_brute_force", {}, [{}]),
             ("raft_tpu_ivf_flat", {"n_lists": 16}, [{"n_probes": 4}, {"n_probes": 16}])]
    part = str(tmp_path / "s.json.partial")
    real = trunner.run_case
    calls = []

    def dying(ds_, name, *a, **kw):
        calls.append(name)
        if name == "raft_tpu_ivf_flat":
            raise RuntimeError("device unavailable")
        return real(ds_, name, *a, **kw)

    monkeypatch.setattr(trunner, "run_case", dying)
    with pytest.raises(SystemExit):
        tfrontier.sweep(ds, grids, k=5, checkpoint_path=part, warmup=0, iters=1, res=CPU)
    assert json.load(open(part))["done_algos"] == ["raft_tpu_brute_force"]
    monkeypatch.setattr(trunner, "run_case",
                        lambda ds_, name, *a, **kw: calls.append(name) or real(ds_, name, *a, **kw))
    used = {}
    results = tfrontier.sweep(ds, grids, k=5, checkpoint_path=part, warmup=0, iters=1, res=CPU,
                              kernels_used=used)
    assert calls == ["raft_tpu_brute_force", "raft_tpu_ivf_flat", "raft_tpu_ivf_flat"]
    assert [r.algo for r in results] == ["raft_tpu_brute_force"] + ["raft_tpu_ivf_flat"] * 2
    assert {a: u["kernel_path"] for a, u in used.items()} == {
        "raft_tpu_brute_force": "torch", "raft_tpu_ivf_flat": "torch"}
    # a failure without "unavailable" is recorded and the sweep goes on
    monkeypatch.setattr(trunner, "run_case", lambda *a, **kw: (_ for _ in ()).throw(
        NotImplementedError("not ported yet (ROADMAP Queue 1 item 6)")))
    assert tfrontier.sweep(ds, grids, k=5, checkpoint_path=str(tmp_path / "x.partial"),
                           res=CPU) == []


def test_sharded_sweep_names_item_7():
    from raft_tpu_torch.bench.__main__ import main

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        main(["frontier", "--sharded", "2", "--platform", "cpu"])


def test_service_wires_the_autotuner(monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.random((200, 8), dtype=np.float32)
    q = rng.random((4, 8), dtype=np.float32)
    index = tflat.build(tflat.IndexParams(n_lists=4), x, res=CPU)
    tuner = tauto.Autotuner(eval_s=3600.0, recall_floor=0.9, registry=TRegistry())
    svc = serve.SearchService(k=3, max_batch=4, autotune=tuner)
    try:
        svc.add_index("t", serve.MutableIndex(index, search_params=tflat.SearchParams(n_probes=4)),
                      warmup=True)
        arb = svc.effort_arbiter("t")
        assert arb is not None and tuner.level("t") == 0
        assert svc.healthz()["indexes"]["t"]["checks"]["autotune"]["status"] == "OK"
        for level in arb.levels():
            arb.set_autotune_level(level)
            params = arb.apply(svc.get("t"))
            want = tflat.search(params or tflat.SearchParams(n_probes=4), index, q, 3, res=CPU)
            got = svc.search("t", q)
            np.testing.assert_array_equal(got[1], want[1].numpy())
        assert svc.stats("t")["recompiles"] == 0 and svc.stats("t")["autotune_level"] == level
        assert svc.healthz()["indexes"]["t"]["checks"]["autotune"]["status"] == "DEGRADED"
        tuner._states["t"].pinned_min = True
        check = svc.healthz()["indexes"]["t"]["checks"]["autotune"]
        assert check["status"] == "DEGRADED" and "minimum effort" in check["detail"]
        assert svc._incident_context()["autotune"] == {"pinned_min_effort": ["t"]}
        svc.remove_index("t")
        assert tuner.level("t") is None
    finally:
        svc.stop()
        tuner.stop()
    monkeypatch.setenv("RAFT_TPU_AUTOTUNE", "1")
    svc = serve.SearchService(k=3, max_batch=4, start=False)
    try:
        assert isinstance(svc.autotuner, tauto.Autotuner)
        svc.add_index("u", serve.MutableIndex(index))
        assert svc.effort_arbiter("u") is not None
    finally:
        svc.stop()
    assert serve.SearchService(k=3, autotune=False, start=False).autotuner is None
