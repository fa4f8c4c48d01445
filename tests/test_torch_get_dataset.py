"""The port's ``bench.get_dataset`` on the CPU: ``--synthetic`` writes what
``bench.datasets.load`` reads, with exact ground truth and raft_tpu's rows;
the big-ann branch streams a prefix of a local ``.fbin`` served in place
of ``urllib.request.urlopen`` (no network anywhere); the HDF5 branch reads
a local file served in place of ``urlretrieve`` (skipped without h5py); a
failed download raises raft_tpu's ``RuntimeError``; and the runner drives
``raft_tpu_ball_cover`` and ``native_ivf_flat`` over the written
directory."""

import io
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu.bench import datasets as jdatasets
from raft_tpu_torch.bench import datasets, get_dataset, runner
from raft_tpu_torch.core import native
from raft_tpu_torch.core.resources import Resources

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _exact_gt(base, queries, k):
    d = ((queries[:, None].astype(np.float64) - base[None].astype(np.float64)) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def test_synthetic_writes_what_load_reads(tmp_path, capsys):
    assert get_dataset.main(["--synthetic", "--scale", "0.002", "-k", "10", "--out-dir",
                             str(tmp_path), "--device", "cpu"]) == 0
    dest = capsys.readouterr().out.strip()
    assert dest == str(tmp_path / "sift-128-euclidean")
    ds = datasets.load(dest)
    want = jdatasets.synthetic("sift-128-euclidean", scale=0.002)
    np.testing.assert_array_equal(ds.base, want.base)
    np.testing.assert_array_equal(ds.queries, want.queries)
    assert ds.gt_neighbors.shape == (ds.queries.shape[0], 10)
    gt = _exact_gt(ds.base, ds.queries, 10)
    assert (ds.gt_neighbors == gt).mean() >= 0.999
    # a second fetch leaves the directory as it is
    mtime = os.path.getmtime(os.path.join(dest, "base.fbin"))
    assert get_dataset.fetch("sift-128-euclidean", str(tmp_path), synthetic=True,
                             scale=0.002, k=10, res=CPU) == dest
    assert os.path.getmtime(os.path.join(dest, "base.fbin")) == mtime


class _Stream(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def test_bigann_branch_streams_a_prefix(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    base = rng.random((5000, 8), dtype=np.float32)
    queries = rng.random((30, 8), dtype=np.float32)
    blobs = {}
    for tag, arr in (("base", base), ("query", queries)):
        path = tmp_path / f"{tag}.fbin"
        datasets.write_bin(str(path), arr)
        blobs[tag] = path.read_bytes()
    asked = []

    def urlopen(url, *a, **kw):
        asked.append(url)
        return _Stream(blobs["base"])

    def urlretrieve(url, filename, *a, **kw):
        asked.append(url)
        with open(filename, "wb") as fh:
            fh.write(blobs["query"])
        return filename, None

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    # deep-100M promises 1e8 rows; scale 2e-5 keeps the first 2,000
    dest = get_dataset.fetch("deep-100M", str(tmp_path / "out"), scale=2e-5, k=5, res=CPU)
    src = get_dataset._BIGANN_SOURCES["deep-100M"]
    assert asked == [src[0], src[1]]
    ds = datasets.load(dest)
    np.testing.assert_array_equal(ds.base, base[:2000])
    np.testing.assert_array_equal(ds.queries, queries)
    assert (ds.gt_neighbors == _exact_gt(base[:2000], queries, 5)).mean() >= 0.999
    assert not [p for p in os.listdir(tmp_path / "out") if p.endswith(".download")]


def test_hdf5_branch(tmp_path, monkeypatch):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(1)
    src = tmp_path / "src.hdf5"
    train = rng.random((400, 6), dtype=np.float32)
    test = rng.random((12, 6), dtype=np.float32)
    with h5py.File(src, "w") as f:
        f.create_dataset("train", data=train)
        f.create_dataset("test", data=test)
        f.attrs["distance"] = "euclidean"

    def urlretrieve(url, filename, *a, **kw):
        assert url == get_dataset._ANN_BENCHMARKS_URL.format(name="tiny-6-euclidean")
        with open(filename, "wb") as fh:
            fh.write(src.read_bytes())
        return filename, None

    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    dest = get_dataset.fetch("tiny-6-euclidean", str(tmp_path / "out"), k=4, res=CPU)
    ds = datasets.load(dest)
    np.testing.assert_array_equal(ds.base, train)
    assert (ds.gt_neighbors == _exact_gt(train, test, 4)).mean() >= 0.999


def test_a_failed_download_raises(tmp_path, monkeypatch):
    def refuse(url, *a, **kw):
        raise urllib.error.URLError("offline")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    for name in ("sift-128-euclidean", "bigann-100M"):
        with pytest.raises(RuntimeError, match="--synthetic"):
            get_dataset.fetch(name, str(tmp_path), res=CPU)


def test_runner_over_the_fetched_directory(tmp_path):
    dest = get_dataset.fetch("sift-128-euclidean", str(tmp_path), synthetic=True, scale=0.002,
                             k=10, res=CPU)
    ds = datasets.load(dest)
    cases = [("raft_tpu_ball_cover", {"seed": 0}, [{"n_probes": 0}, {"n_probes": 10_000}])]
    if native.available():
        cases.append(("native_ivf_flat", {"n_lists": 16}, [{"n_probes": 8}]))
    rows = {algo: runner.run_case(ds, algo, bp, sps, k=10, iters=1, res=CPU)
            for algo, bp, sps in cases}
    for algo, got in rows.items():
        assert [r.algo for r in got] == [algo] * len(got)
        assert all(r.recall > 0.5 for r in got), [(r.algo, r.recall) for r in got]
    assert rows["raft_tpu_ball_cover"][1].recall == 1.0   # every ball probed: exact
