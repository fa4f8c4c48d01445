"""Port parity of ``obs.quality`` (the online recall auditor) on the CPU.

The oracle (``_exact_topk``) gives raft_tpu's ids on every metric (scores
within rtol 1e-5).  Two auditors with one seed and one sampling rate, fed
the same ``observe()`` calls over a MutableIndex raft_tpu built, mutated
and saved (raft_tpu's own instance beside the port's load of the file),
make the same sample decisions and publish the same recall, EWMA, rank
displacement, gauges and alarm edges (exactly equal: the same numpy on the
same rows).  Through the port's service, a corrupted index fires the alarm
once, a repair publishes the recovery edge and re-arms it; a full queue
drops and never blocks; what reaches the auditor are copies no later batch
overwrites.  No test reads the clock against a bound."""

import copy
import os
import threading

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.obs import events as jevents
from raft_tpu.obs import quality as jquality
from raft_tpu.obs.registry import MetricsRegistry as JRegistry
from raft_tpu.serve import mutation as jmut
from raft_tpu_torch import serve
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.obs import events as tevents
from raft_tpu_torch.obs import health as thealth
from raft_tpu_torch.obs import quality as tquality
from raft_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from raft_tpu_torch.serve import mutation as tmut

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
N, D, K = 600, 32, 10
WAIT_S = 120


@pytest.fixture(autouse=True)
def _dumps_in_tmp(tmp_path, monkeypatch):
    # alarm edges dump flight records and incidents: keep them in the test's dir
    monkeypatch.setenv("RAFT_TPU_FLIGHT_DIR", str(tmp_path))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine"])
def test_exact_topk_matches_raft_tpu(metric):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((400, D)).astype(np.float32)
    ids = rng.permutation(10_000)[:400].astype(np.int64)
    q = rng.standard_normal((9, D)).astype(np.float32)
    for k in (1, 10, 400, 500):
        jd, ji = jquality._exact_topk(x, ids, q, k, metric)
        td, ti = tquality._exact_topk(x, ids, q, k, metric)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def saved_pair(tmp_path_factory):
    """(raft_tpu MutableIndex, the port's load of its save) over one raft_tpu
    IVF-Flat index with tombstones and upserted side rows."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((N, D)).astype(np.float32)
    new = rng.standard_normal((12, D)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("q") / "j.mut")
    j = jmut.MutableIndex(jflat.build(jflat.IndexParams(n_lists=8, kmeans_n_iters=5), x),
                          search_params=jflat.SearchParams(n_probes=3))
    j.upsert(new[:8])
    j.upsert(new[8:], ids=[3, 5, N + 1, N + 30])
    j.delete(np.arange(0, N, 11))
    j.save(path)
    t = tmut.MutableIndex.load(path, search_params=tflat.SearchParams(n_probes=3), res=CPU)
    return j, t, rng.standard_normal((8, D)).astype(np.float32)


def _capture(events_mod):
    seen = []
    sub = events_mod.subscribe(seen.append, kinds=frozenset({"quality_alarm"}),
                               name="quality-parity")
    return seen, sub


def test_two_auditors_agree_over_raft_tpus_saved_index(saved_pair):
    jm, tm, q = saved_pair
    jv, jids = jm.live_vectors()
    tv, tids = tm.live_vectors()
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tv, jv)
    # the oracle's own answer (recall 1) and a served search (below it)
    good = jquality._exact_topk(jv, jids, q, K, jm.metric)[1]
    served = np.asarray(jm.search(q, K)[1])
    wrong = np.full_like(good, 99_999)
    half = good.copy()
    half[:, 5:] = 99_999
    reversed_ = good[:, ::-1].copy()
    # (version, served ids): a clean start, an excursion, a recovery, a
    # second excursion, then a new version that starts a fresh EWMA
    script = ([(1, good)] * 3 + [(1, wrong)] * 2 + [(1, half)] + [(1, good)] * 4
              + [(1, reversed_), (1, served)] + [(1, wrong)] * 3 + [(2, good)] * 2
              + [(2, half)])
    fired = {"j": [], "t": []}
    jreg, treg = JRegistry(), TRegistry()
    jaud = jquality.QualityAuditor(k=K, sampling=0.6, threshold=0.9, ewma_alpha=0.4, seed=7,
                                   registry=jreg, on_degraded=lambda *a: fired["j"].append(a))
    taud = tquality.QualityAuditor(k=K, sampling=0.6, threshold=0.9, ewma_alpha=0.4, seed=7,
                                   registry=treg, on_degraded=lambda *a: fired["t"].append(a))
    jseen, jsub = _capture(jevents)
    tseen, tsub = _capture(tevents)
    try:
        decisions = []
        for version, ids in script:
            a = jaud.observe("p", version, jm, q, ids)
            b = taud.observe("p", version, tm, torch.from_numpy(q).numpy(), ids)
            decisions.append((a, b))
            # one sample at a time, so that both EWMAs see the same order
            assert jaud.flush(WAIT_S) and taud.flush(WAIT_S)
            assert taud.recall_ewma("p") == jaud.recall_ewma("p")
        assert all(a == b for a, b in decisions) and 3 < sum(a for a, _ in decisions) < len(script)
        js, ts = jaud.snapshot(), taud.snapshot()
        assert ts == js
        assert ts["errors"] == 0 and ts["indexes"]["p"]["version"] == 2
        assert fired["t"] == fired["j"] and fired["t"]
        strip = [(e.reason, e.recovered, {k: v for k, v in e.fields.items()}) for e in jseen]
        assert [(e.reason, e.recovered, dict(e.fields)) for e in tseen] == strip
        assert any(r for _, r, _ in strip), "the script must include a recovery edge"
        for name in ("raft_tpu_recall", "raft_tpu_recall_ewma", "raft_tpu_rank_displacement"):
            assert treg.gauge(name).collect() == jreg.gauge(name).collect(), name
        assert (treg.counter("raft_tpu_quality_audited_total").collect()
                == jreg.counter("raft_tpu_quality_audited_total").collect())
        assert "quality" in treg.snapshot()
    finally:
        jsub.unsubscribe()
        tsub.unsubscribe()
        jaud.stop()
        taud.stop()
    assert "quality" not in treg.snapshot(), "stop() detaches the snapshot provider"


def test_full_queue_drops_and_never_blocks(saved_pair):
    _, tm, q = saved_pair
    reg = TRegistry()
    aud = tquality.QualityAuditor(k=5, sampling=1.0, queue_cap=1, registry=reg)
    release = threading.Event()
    aud._audit = lambda sample: release.wait(timeout=WAIT_S)   # wedge the worker
    try:
        ids = np.zeros((q.shape[0], 5), np.int64)
        for _ in range(20):
            aud.observe("w", 1, tm, q, ids)
        snap = aud.snapshot()
        assert snap["dropped"] > 0 and snap["dropped"] + snap["submitted"] == 20
        assert reg.counter("raft_tpu_quality_dropped_total").value(index="w") == snap["dropped"]
    finally:
        release.set()
        aud.stop()
    off = tquality.QualityAuditor(sampling=0.0, registry=TRegistry())
    try:
        assert not off.observe("z", 1, tm, q, ids) and off.snapshot()["submitted"] == 0
    finally:
        off.stop()
    with pytest.raises(ValueError, match="sampling"):
        tquality.QualityAuditor(sampling=1.5)


def _clustered(rng, n, n_q):
    """Clustered rows: shuffling IVF centers on such data sends probes to the
    wrong lists (raft_tpu's test corruption)."""
    centers = (rng.standard_normal((24, D)) * 6.0).astype(np.float32)
    x = centers[rng.integers(0, 24, n)] + rng.standard_normal((n, D)).astype(np.float32) * 0.25
    q = centers[rng.integers(0, 24, n_q)] + rng.standard_normal((n_q, D)).astype(np.float32) * 0.25
    return x.astype(np.float32), q.astype(np.float32)


def test_corrupted_index_fires_once_and_repair_rearms(monkeypatch):
    rng = np.random.default_rng(17)
    x, q = _clustered(rng, N, 16)
    good = tflat.build(tflat.IndexParams(n_lists=16), x, res=CPU)
    bad = copy.copy(good)
    bad.centers = good.centers[torch.from_numpy(rng.permutation(16))]
    sp = tflat.SearchParams(n_probes=2)
    fired = []
    auditor = tquality.QualityAuditor(k=K, sampling=1.0, threshold=0.9, ewma_alpha=0.5,
                                      on_degraded=lambda *a: fired.append(a))
    seen, sub = _capture(tevents)
    svc = serve.SearchService(k=K, max_batch=8, max_delay_ms=1.0, auditor=auditor)
    try:
        svc.add_index("qa", serve.MutableIndex(good, search_params=sp), warmup=True)
        for i in range(q.shape[0]):
            svc.search("qa", q[i], timeout=WAIT_S)
        assert auditor.flush(WAIT_S) and not fired
        assert auditor.recall_ewma("qa") >= 0.9
        version = svc.swap("qa", serve.MutableIndex(bad, search_params=sp))
        for i in range(q.shape[0]):
            svc.search("qa", q[i], timeout=WAIT_S)
        assert auditor.flush(WAIT_S)
        assert len(fired) == 1 and fired[0][:2] == ("qa", version) and fired[0][2] < 0.9
        alarms = [e for e in seen if not e.recovered]
        assert len(alarms) == 1 and alarms[0].fields["index"] == "qa"
        report = svc.healthz()
        assert report["status"] != thealth.OK
        assert report["indexes"]["qa"]["checks"]["recall"]["status"] != thealth.OK
        plan = svc.explain("qa", q[0], timeout=WAIT_S)
        assert plan["audit"]["verdict"] == "below_threshold"
        # repair the served version in place: the same version climbs back
        bad.centers = good.centers
        for _ in range(3):
            for i in range(q.shape[0]):
                svc.search("qa", q[i], timeout=WAIT_S)
        assert auditor.flush(WAIT_S)
        recovered = [e for e in seen if e.recovered]
        assert len(recovered) == 1 and recovered[0].fields["version"] == version
        assert len(fired) == 1 and not auditor.snapshot()["indexes"]["qa"]["alarmed"]
        svc.attach_auditor(None)
        assert svc.explain("qa", q[0], timeout=WAIT_S)["audit"] == {"available": False}
    finally:
        sub.unsubscribe()
        svc.stop()
        auditor.stop()


class _Keeper:
    """An auditor stand-in that keeps what ``observe`` hands it."""

    threshold = 0.9

    def __init__(self):
        self.kept = []

    def observe(self, name, version, index, queries, ids):
        self.kept.append((queries, ids))

    def recall_ewma(self, name):
        return None


@pytest.mark.parametrize("depth", [1, 2])
def test_observer_gets_copies_no_later_batch_overwrites(depth):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((300, D)).astype(np.float32)
    q = rng.standard_normal((24, D)).astype(np.float32)
    index = tflat.build(tflat.IndexParams(n_lists=4), x, res=CPU)
    keeper = _Keeper()
    svc = serve.SearchService(k=K, max_batch=4, max_delay_ms=1.0, pipeline_depth=depth,
                              auditor=keeper)
    try:
        svc.add_index("c", serve.MutableIndex(index, search_params=tflat.SearchParams(n_probes=4)),
                      warmup=True)
        answers = [svc.search("c", q[i:i + 4], timeout=WAIT_S) for i in range(0, 24, 4)]
    finally:
        svc.stop()
    # warmup batches are not observed; each of the six batches is, unchanged
    assert len(keeper.kept) == 6
    for b, ((kq, kids), (_, ids)) in enumerate(zip(keeper.kept, answers)):
        np.testing.assert_array_equal(kq, q[4 * b:4 * b + 4])
        np.testing.assert_array_equal(kids, ids)
