"""Port parity of the benchmark harness ``raft_tpu_torch.bench`` against
``raft_tpu.bench`` on the same numpy inputs: the dataset files byte for
byte, the generators, ground truth, the reference-conf translation, the
bench records, the runner's results and the ladder on the CPU."""

import os
import json

import numpy as np
import pytest
import torch

from raft_tpu.bench import conf as jconf
from raft_tpu.bench import datasets as jds
from raft_tpu.bench import export as jexport
from raft_tpu.bench import runner as jrunner
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.stats import neighborhood_recall as j_neighborhood_recall
from raft_tpu_torch import kernels
from raft_tpu_torch.bench import conf as tconf
from raft_tpu_torch.bench import datasets as tds
from raft_tpu_torch.bench import device_time, ladder, prims
from raft_tpu_torch.bench import export as texport
from raft_tpu_torch.bench import runner as trunner
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.stats.metrics import neighborhood_recall

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _arrays(rng):
    return {
        "fbin": rng.standard_normal((37, 5)).astype(np.float32),
        "u8bin": rng.integers(0, 256, (37, 5)).astype(np.uint8),
        "i8bin": rng.integers(-128, 128, (37, 5)).astype(np.int8),
        "ibin": rng.integers(-2**31, 2**31 - 1, (37, 5)).astype(np.int32),
        "fvecs": rng.standard_normal((11, 7)).astype(np.float32),
        "ivecs": rng.integers(0, 1000, (11, 7)).astype(np.int32),
        "bvecs": rng.integers(0, 256, (11, 7)).astype(np.uint8),
    }


@pytest.mark.parametrize("ext", ["fbin", "u8bin", "i8bin", "ibin", "fvecs", "ivecs", "bvecs"])
def test_files_round_trip_byte_for_byte_both_ways(ext, tmp_path):
    arr = _arrays(np.random.default_rng(0))[ext]
    vecs = ext.endswith("vecs")
    j_path, t_path = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    (jds.write_vecs if vecs else jds.write_bin)(j_path, arr)
    (tds.write_vecs if vecs else tds.write_bin)(t_path, arr)
    assert open(j_path, "rb").read() == open(t_path, "rb").read()
    for reader in ((tds.read_vecs, jds.read_vecs) if vecs else (tds.read_bin, jds.read_bin)):
        for path in (j_path, t_path):
            back = reader(path)
            assert back.dtype == arr.dtype and np.array_equal(back, arr)
    if not vecs:
        np.testing.assert_array_equal(tds.read_bin(j_path, rows=4), jds.read_bin(t_path, rows=4))
        assert isinstance(tds.read_bin(j_path, mmap=True), np.memmap)


def test_dataset_directories_load_in_both_packages(tmp_path):
    rng = np.random.default_rng(1)
    ds = tds.Dataset("u8", rng.integers(0, 256, (50, 8)).astype(np.uint8),
                     rng.integers(0, 256, (6, 8)).astype(np.uint8),
                     gt_neighbors=rng.integers(0, 50, (6, 3)).astype(np.int32),
                     gt_distances=rng.random((6, 3)).astype(np.float32))
    tds.save(ds, str(tmp_path / "t"))
    jds.save(jds.Dataset("u8", ds.base, ds.queries, ds.gt_neighbors, ds.gt_distances),
             str(tmp_path / "j"))
    for name in ("base.u8bin", "query.u8bin", "groundtruth.neighbors.ibin",
                 "groundtruth.distances.fbin"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    for d in ("t", "j"):
        t, j = tds.load(str(tmp_path / d)), jds.load(str(tmp_path / d))
        for field in ("base", "queries", "gt_neighbors", "gt_distances"):
            assert np.array_equal(getattr(t, field), getattr(j, field))
    # the TEXMEX layout
    tds.write_vecs(str(tmp_path / "x_base.fvecs"), ds.base.astype(np.float32))
    tds.write_vecs(str(tmp_path / "x_query.fvecs"), ds.queries.astype(np.float32))
    tds.write_vecs(str(tmp_path / "x_groundtruth.ivecs"), ds.gt_neighbors)
    t, j = tds.load(str(tmp_path)), jds.load(str(tmp_path))
    assert t.name == j.name == "x"
    assert np.array_equal(t.base, j.base) and np.array_equal(t.gt_neighbors, j.gt_neighbors)


@pytest.mark.parametrize("clustered", [True, False])
@pytest.mark.parametrize("name,scale", [("sift-128-euclidean", 0.002),
                                        ("glove-100-inner", 0.001),
                                        ("mnist-784-euclidean", 0.02)])
def test_synthetic_datasets_equal_raft(name, scale, clustered):
    t = tds.synthetic(name, scale=scale, seed=3, clustered=clustered)
    j = jds.synthetic(name, scale=scale, seed=3, clustered=clustered)
    assert (t.name, t.metric) == (j.name, j.metric)
    assert np.array_equal(t.base, j.base) and np.array_equal(t.queries, j.queries)
    t = tds.synthetic_geometry("g", 3000, 12, "inner_product", n_queries=17, seed=5,
                               clustered=clustered)
    j = jds.synthetic_geometry("g", 3000, 12, "inner_product", n_queries=17, seed=5,
                               clustered=clustered)
    assert np.array_equal(t.base, j.base) and np.array_equal(t.queries, j.queries)
    with pytest.raises(ValueError):
        tds.synthetic("no-such-set")


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("chunked", [False, True])
def test_groundtruth_equals_raft(metric, chunked, monkeypatch):
    """Ids equal wherever the reference's value is not tied with a
    neighbour's (the two brute forces sum in other orders); values within
    rtol 1e-5.  ``chunked``: the base streamed in chunks of 700 rows."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((2000, 16)).astype(np.float32)
    queries = rng.standard_normal((40, 16)).astype(np.float32)
    if chunked:
        monkeypatch.setattr(tds, "_GT_BASE_CHUNK_BYTES", 700 * 16 * 4)
        monkeypatch.setattr(jds, "_GT_BASE_CHUNK_BYTES", 700 * 16 * 4)
    t = tds.generate_groundtruth(tds.Dataset("x", base, queries, metric=metric), k=20,
                                 batch=16, res=CPU)
    j = jds.generate_groundtruth(jds.Dataset("x", base, queries, metric=metric), k=20,
                                 batch=16)
    from _torch_parity import assert_topk_match

    assert t.gt_neighbors.dtype == np.int32 and t.gt_neighbors.shape == (40, 20)
    assert_topk_match(t.gt_distances, t.gt_neighbors, j.gt_distances, j.gt_neighbors,
                      rtol=1e-5, atol=1e-4)


_CONF = {
    "dataset": {"name": "deep-100M", "base_file": "deep-100M/base.1B.fbin",
                "subset_size": 100000000, "query_file": "deep-100M/query.public.10K.fbin",
                "distance": "euclidean"},
    "search_basic_param": {"batch_size": 10000, "k": 10},
    "index": [
        {"name": "raft_ivf_pq.d96b5n50K", "algo": "raft_ivf_pq",
         "build_param": {"nlist": 50000, "pq_dim": 96, "pq_bits": 5, "ratio": 10, "niter": 25},
         "file": "x",
         "search_params": [{"nprobe": 20, "internalDistanceDtype": "half",
                            "smemLutDtype": "fp8", "refine_ratio": 2},
                           {"nprobe": 100, "smemLutDtype": "half", "refine_ratio": 1}]},
        {"name": "faiss_gpu_ivf_flat.nlist50K", "algo": "faiss_gpu_ivf_flat",
         "build_param": {"nlist": 50000, "ratio": 2}, "file": "x",
         "search_params": [{"nprobe": 50}]},
        {"name": "raft_cagra.dim32", "algo": "raft_cagra",
         "build_param": {"graph_degree": 32, "intermediate_graph_degree": 64}, "file": "x",
         "search_params": [{"itopk": 64, "search_width": 2, "max_iterations": 20}]},
        {"name": "hnswlib.M12", "algo": "hnswlib", "build_param": {"M": 12}, "file": "x",
         "search_params": [{"ef": 10}]},
        {"name": "ggnn.a", "algo": "ggnn", "build_param": {}, "file": "x"},
        {"name": "raft_ivf_flat.broken", "algo": "raft_ivf_flat", "build_param": {},
         "file": "x"},
    ],
}


def _same_translation(t, j):
    (ti, tc, ts), (ji, jc, js) = t, j
    assert ti == ji and tc == jc
    assert [s.split(":")[0] for s in ts] == [s.split(":")[0] for s in js]


@pytest.mark.parametrize("algo_filter", [None, {"raft_cagra.dim32", "raft_ivf_pq"}])
def test_conf_translate_equals_raft(algo_filter, tmp_path):
    _same_translation(tconf.translate(_CONF, algo_filter=algo_filter),
                      jconf.translate(_CONF, algo_filter=algo_filter))
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(_CONF))
    _same_translation(tconf.load(str(path)), jconf.load(str(path)))


def test_conf_translated_names_are_the_port_params_fields():
    import dataclasses

    from raft_tpu_torch.neighbors import cagra, ivf_pq

    _, cfg, _ = tconf.translate(_CONF)
    mods = {"raft_tpu_ivf_pq": ivf_pq, "raft_tpu_ivf_flat": tflat, "raft_tpu_cagra": cagra}
    for a in cfg["algos"]:
        fields = {f.name for f in dataclasses.fields(mods[a["name"]].IndexParams)}
        assert set(a["build_param"]) <= fields
        mods[a["name"]].IndexParams(**a["build_param"])
        for sp in a["search_params"]:
            sp = {k: v for k, v in sp.items() if k != "refine_ratio"}
            mods[a["name"]].SearchParams(**sp)
    # a name the port's params lack is refused, never dropped
    with pytest.raises(ValueError, match="not a field"):
        tconf._check_fields({"name": "raft_tpu_cagra", "build_param": {"no_such": 1},
                             "search_params": [{}]})


@pytest.mark.parametrize("group,dims,n", [("base", 128, 1_000_000), ("large", 96, 3000)])
def test_algo_yaml_and_datasets_yaml_equal_raft(group, dims, n, tmp_path):
    y = tmp_path / "raft_ivf_pq.yaml"
    y.write_text("name: raft_ivf_pq\ngroups:\n"
                 "  base:\n    build:\n      nlist: [1024, 2048]\n      pq_dim: [64, 256]\n"
                 "      ratio: [10]\n    search:\n      nprobe: [10, 50]\n"
                 "      smemLutDtype: [\"half\"]\n"
                 "  large:\n    build:\n      nlist: [5000, 64]\n      pq_dim: [48]\n"
                 "    search:\n      nprobe: [8]\n      refine_ratio: [1, 2]\n")
    info = {"name": "x", "dims": dims, "metric": "sqeuclidean", "subset_size": n, "k": 10}
    t = tconf.load_algo_yaml(str(y), group=group, dataset_info=info)
    j = jconf.load_algo_yaml(str(y), group=group, dataset_info=info)
    assert t == j and t["algos"]
    with pytest.raises(ValueError):
        tconf.load_algo_yaml(str(y), group="nope", dataset_info=info)
    d = tmp_path / "datasets.yaml"
    d.write_text("- name: deep-1B\n  base_file: deep-1B/base.1B.fbin\n  dims: 96\n"
                 "  distance: inner_product\n- name: bigann-100M\n"
                 "  base_file: bigann-100M/base.1B.u8bin\n  subset_size: 100000000\n"
                 "  distance: euclidean\n- dims: 3\n")
    assert tconf.load_datasets_yaml(str(d)) == jconf.load_datasets_yaml(str(d))


_PAYLOADS = [
    ({"metric": "m", "value": 100.0, "unit": "queries/s", "recall": 0.95, "platform": "x",
      "kernel_path": "cuda"},
     {"metric": "m", "value": 70.0, "unit": "queries/s", "recall": 0.95, "platform": "x",
      "kernel_path": "cuda"}),
    ({"metric": "m", "value": 10.0, "unit": "ms", "latency_ms": 2.0, "recall": 0.9},
     {"metric": "m", "value": 11.0, "unit": "ms", "latency_ms": 2.1, "recall": 0.87}),
    ({"metric": "m", "value": 5.0, "unit": "s", "recompiles": 0},
     {"metric": "m", "value": 5.0, "unit": "s", "recompiles": 2}),
    ({"metric": "a", "value": 1.0}, {"metric": "b", "value": 1.0}),
    ({"metric": "m", "value": 1.0, "platform": "cpu"}, {"metric": "m", "value": 1.0}),
    ({"metric": "m"}, {"metric": "m"}),
    ({"metric": "m", "value": 9.0, "unit": "ops", "kernel_path": "cuda"},
     {"metric": "m", "value": 9.5, "unit": "ops", "kernel_path": "torch"}),
]


@pytest.mark.parametrize("case", range(len(_PAYLOADS)))
def test_records_and_comparison_equal_raft(case, tmp_path):
    base, cand = _PAYLOADS[case]
    assert texport.compare_records(base, cand) == jexport.compare_records(base, cand)
    assert texport.compare_records(base, cand, rtol=0.5, recall_atol=0.0) == \
        jexport.compare_records(base, cand, rtol=0.5, recall_atol=0.0)
    stamped = dict(base, kernel_path="cuda")
    assert texport.bench_record(stamped) == jexport.bench_record(stamped)
    path = texport.write_bench_record(stamped, str(tmp_path / "r.json"))
    assert texport.load_record(path) == jexport.load_record(path) == stamped
    assert texport.bench_record({"metric": "m"})["record"]["kernel_path"] in ("cuda", "torch")
    with pytest.raises(ValueError):
        texport.bench_record({"value": 1})
    assert texport.write_bench_record(stamped, "-") == ""


def test_compare_main_exit_codes(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    texport.write_bench_record({"metric": "m", "value": 100.0, "unit": "queries/s"}, str(a))
    texport.write_bench_record({"metric": "m", "value": 10.0, "unit": "queries/s"}, str(b))
    assert texport.compare_main(["--baseline", str(a), "--candidate", str(a)]) == 0
    assert texport.compare_main(["--baseline", str(a), "--candidate", str(b)]) == 1
    assert texport.compare_main(["--baseline", str(tmp_path / "no"), "--candidate", str(a)]) == 2


@pytest.fixture(scope="module")
def bench_ds():
    ds = tds.synthetic("sift-128-euclidean", scale=0.002, n_queries=60, seed=0)
    tds.generate_groundtruth(ds, k=10, res=CPU)
    return ds


def test_run_case_brute_force_fields_and_export(bench_ds, tmp_path):
    res = trunner.run_case(bench_ds, "raft_tpu_brute_force", {}, [{}], k=10, warmup=0, iters=1,
                           res=CPU)
    assert len(res) == 1
    r = res[0]
    assert list(r.to_dict()) == list(jrunner.RunResult(*([0] * 10)).to_dict())
    assert r.recall == 1.0 and r.qps > 0 and r.build_time_s >= 0
    assert r.device_time_s is None and r.device_qps is None   # no device time on the CPU
    trunner.save_results(res, str(tmp_path / "r.json"))
    texport.to_csv(res, str(tmp_path / "r.csv"))
    back = texport.from_json(str(tmp_path / "r.json"))
    assert back[0].to_dict() == r.to_dict()
    assert jexport.from_json(str(tmp_path / "r.json"))[0].to_dict() == r.to_dict()
    assert (tmp_path / "r.csv").read_text().splitlines()[0].split(",") == jexport._FIELDS


def test_run_case_ivf_flat_on_a_saved_and_loaded_index(bench_ds, tmp_path, monkeypatch):
    """raft_tpu builds and saves an IVF-Flat index; both runners search it
    (the port's after loading the file): the same recall, search param by
    search param."""
    jidx = jflat.build(jflat.IndexParams(n_lists=32, kmeans_n_iters=5), bench_ds.base)
    path = str(tmp_path / "ivf_flat.idx")
    jflat.save(path, jidx)

    def j_build(self, dataset):
        self._mod, self._index, self._sp = jflat, jidx, jflat.SearchParams()

    def t_build(self, dataset):
        self._mod, self._index = tflat, tflat.load(path, res=self.res)
        self._sp = tflat.SearchParams()

    monkeypatch.setattr(jrunner.IvfFlatANN, "build", j_build)
    monkeypatch.setattr(trunner.IvfFlatANN, "build", t_build)
    sps = [{"n_probes": 1}, {"n_probes": 4}, {"n_probes": 32}]
    want = jrunner.run_case(bench_ds, "raft_tpu_ivf_flat", {}, sps, k=10, warmup=0, iters=1)
    got = trunner.run_case(bench_ds, "raft_tpu_ivf_flat", {}, sps, k=10, warmup=0, iters=1,
                           res=CPU)
    assert [r.recall for r in got] == [r.recall for r in want]
    assert got[0].recall < 1.0 and got[-1].recall == 1.0
    for g, w in zip(got, want):
        assert (g.algo, g.dataset, g.k, g.search_param) == (w.algo, w.dataset, w.k, w.search_param)


def test_runner_algorithms_and_not_ported_wrappers(bench_ds):
    assert set(trunner.ALGORITHMS) == set(jrunner.ALGORITHMS)
    # raft_tpu_cagra_vpq and hnswlib_format are served since slice 11
    # (test_run_case_cagra_vpq_and_hnswlib_format_rows)
    for name in ("raft_tpu_ball_cover", "sklearn", "hnsw_native", "native_ivf_flat",
                 "native_ivf_pq", "native_cagra"):
        with pytest.raises(NotImplementedError):
            trunner.ALGORITHMS[name]("sqeuclidean", {}, res=CPU).build(bench_ds.base)
    with pytest.raises(ValueError, match="groundtruth"):
        trunner.run_case(tds.Dataset("x", bench_ds.base, bench_ds.queries),
                         "raft_tpu_brute_force", {}, [{}], res=CPU)


@pytest.mark.parametrize("algo", ["raft_tpu_cagra_vpq", "hnswlib_format"])
def test_run_case_cagra_vpq_and_hnswlib_format_rows(bench_ds, algo):
    """The two rows that raised before slice 11, at a tiny scale: a VPQ
    index walked on the plain walk ("torch" even on a card), and a CAGRA
    graph through the hnswlib file and back."""
    bp = {"graph_degree": 16, "intermediate_graph_degree": 32, "build_algo": "brute_force"}
    sps = [{"itopk_size": 32}] if algo == "raft_tpu_cagra_vpq" else [{"ef": 32}]
    kernels.consume_kernel_path()
    rows = trunner.run_case(bench_ds, algo, bp, sps, k=10, warmup=0, iters=1, res=CPU)
    assert len(rows) == 1 and rows[0].algo == algo and rows[0].recall > 0.5
    assert kernels.consume_kernel_path() == "torch" and rows[0].device_time_s is None


def test_run_config_labels_and_numpy_floor(bench_ds):
    cfg = {"algos": [{"name": "numpy_exact", "search_params": [{"tile": 16}], "label": "np.x"},
                     {"name": "raft_tpu_ivf_pq", "build_param": {"n_lists": 8, "pq_dim": 32},
                      "search_params": [{"n_probes": 8, "refine_ratio": 4}]}]}
    res = trunner.run_config(bench_ds, cfg, k=10, res=CPU)
    assert [r.algo for r in res] == ["np.x", "raft_tpu_ivf_pq"]
    assert res[0].recall == 1.0 and res[1].recall >= 0.9


def test_neighborhood_recall_equals_raft():
    rng = np.random.default_rng(6)
    ids = rng.integers(-1, 30, (20, 7))
    ref = rng.integers(-1, 30, (20, 9))
    assert neighborhood_recall(ids, ref) == pytest.approx(
        float(j_neighborhood_recall(ids, ref)), abs=1e-7)


def test_measure_device_time_is_none_without_device_work():
    assert device_time.measure_device_time(lambda a: a + 1, torch.ones(3)) is None
    assert device_time.busy_seconds([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == 4.0
    assert device_time.card("cpu") == {"name": "cpu", "power_limit": None}


def test_measure_device_time_retakes_a_window_without_device_records():
    """A traced window that came back with no device record (or only empty
    ones) is taken again, up to ``TRACE_ATTEMPTS`` windows in all."""
    windows = iter([[], [(3.0, 3.0)], [(1.0, 2.5), (2.0, 4.0)], [(9.0, 10.0)]])
    taken = []

    def trace():
        taken.append(1)
        return next(windows)

    assert device_time.first_busy(trace) == [(1.0, 2.5), (2.0, 4.0)] and len(taken) == 3
    taken.clear()
    assert device_time.first_busy(lambda: taken.append(1) or []) == []
    assert len(taken) == device_time.TRACE_ATTEMPTS


def test_measure_device_time_retakes_a_window_that_lost_kernel_records(monkeypatch):
    """A window holding fewer records of a kernel than the call launched is
    taken again, as an empty one is; ``TRACE_ATTEMPTS`` such windows give
    None.  The fake trace stands in for ``torch.profiler`` on the card."""
    calls = []

    def search():
        kernels.count_launch("select_k")
        kernels.count_launch("select_k")
        kernels.count_launch("ivf_scan_query_major_filt")

    whole = [(0.0, 2.0, "void select_k_warp_kernel<2, false>(Row, int)"),
             (2.0, 3.0, "select_k_sort_kernel<true>"), (3.0, 7.0, "query_major_kernel<0>"),
             (7.0, 9.0, "merge_parts_kernel")]
    windows = iter([whole[1:], [r for r in whole if "query" not in r[2]], whole])

    def fake_trace(fn, *args):
        before = kernels.launch_counts()
        fn(*args)
        after = kernels.launch_counts()
        calls.append(1)
        return next(windows), {k: after[k] - before[k] for k in after if after[k] > before[k]}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(device_time, "trace_device_spans", fake_trace)
    assert device_time.measure_device_time(search) == pytest.approx(9e-6)
    assert len(calls) == 3
    assert device_time.missing_records(whole[1:], {"select_k": 2}) == 1
    assert device_time.missing_records(whole, {"select_k": 2, "ivf_scan_query_major": 1}) == 0
    calls.clear()
    windows = iter([whole[1:]] * device_time.TRACE_ATTEMPTS)
    assert device_time.measure_device_time(search) is None
    assert len(calls) == device_time.TRACE_ATTEMPTS
    # the port's trace ranges are device annotations, not device work
    from types import SimpleNamespace

    cuda = torch.autograd.DeviceType.CUDA
    assert device_time.is_device_work(SimpleNamespace(device_type=cuda, name=whole[0][2]))
    assert not device_time.is_device_work(
        SimpleNamespace(device_type=cuda, name="raft_tpu.ivf_flat.search"))
    assert not device_time.is_device_work(
        SimpleNamespace(device_type=cuda, name="ProfilerStep#1", is_user_annotation=True))


def test_ladder_configs_1_to_3_on_the_cpu_at_floor_sizes():
    recs = ladder.run(CPU, "1,2,3", scale=0.02)
    assert [r["config"] for r in recs] == ["1_pairwise_l2_1kx128", "2_bruteforce_sift10k@n200",
                                            "3_ivf_flat_sift1m@n20000"]
    assert recs[0]["pass"] is True and recs[0]["max_rel_err_vs_numpy"] < 1e-4
    assert recs[1]["recall"] == 1.0 and recs[1]["pass"] == "scaled"
    assert recs[2]["recall"] >= 0.9 and recs[2]["pass"] == "scaled"
    for r in recs:
        assert r["device"]["name"] == "cpu" and r["kernel_path"] == "torch"
        assert r.get("device_seconds") is None and r.get("mfu_f32") is None


def test_prims_cases_keep_raft_names():
    names = [c["name"] for c in prims._cases(CPU)]
    assert len(names) == len(set(names)) == 3 + 34 + 2 + 2 + 1 + 1
    assert "ivf_scan_ab/100kx96/p32/query_major" in names
    assert "ivf_scan_ab/100kx96/p32/probe_major" in names
    assert "bf_knn_ab/200kx96/q4096/k10" in names and "fused_l2_nn/8192x1024x128" in names
    rows = prims.run("select_k/4096x2048/k10", res=CPU)
    assert [r["name"] for r in rows] == ["select_k/4096x2048/k10"] and rows[0]["seconds"] > 0


def test_cli_frontier_raises_and_compare_dispatches(tmp_path):
    from raft_tpu_torch.bench.__main__ import main

    for argv in (["frontier"], ["--frontier"], ["--scale", "0.01", "--frontier"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(argv)
    a = tmp_path / "a.json"
    texport.write_bench_record({"metric": "m", "value": 1.0, "unit": "queries/s"}, str(a))
    assert main(["compare", "--baseline", str(a), "--candidate", str(a)]) == 0
