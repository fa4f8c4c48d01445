"""Dataset fetcher CLI (counterpart of ``raft_tpu.bench.get_dataset``; the
reference's raft-ann-bench ``get_dataset``): fetch a standard ANN
benchmark dataset, convert it to the on-disk layout the runner reads
(big-ann ``base.fbin`` / ``query.fbin`` / ``groundtruth.*``, see
``datasets.save`` / ``load``), and make exact ground truth
(``brute_force.knn``: fused_knn on the card).

    python -m raft_tpu_torch.bench.get_dataset --synthetic --scale 0.01 \\
        --out-dir data/

``--synthetic`` writes the seeded stand-in with the dataset's geometry
(the rows raft_tpu writes for the same name and scale) and needs no
network; without it the dataset is downloaded over the standard library
(raft_tpu's sources).  ``--device cpu`` makes the ground truth on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

from raft_tpu_torch.core.resources import Resources

#: ann-benchmarks HDF5 mirrors
_ANN_BENCHMARKS_URL = "https://ann-benchmarks.com/{name}.hdf5"
#: big-ann-benchmarks binary sources of the large datasets: base file, the
#: published disjoint query file, and the row count the "-100M" name
#: promises (the files hold 1B rows; the download keeps a prefix)
_BIGANN_SOURCES = {
    "deep-100M": (
        "https://storage.yandexcloud.net/yandex-research/ann-datasets/DEEP/base.1B.fbin",
        "https://storage.yandexcloud.net/yandex-research/ann-datasets/DEEP/query.public.10K.fbin",
        100_000_000,
    ),
    "bigann-100M": (
        "https://dl.fbaipublicfiles.com/billion-scale-ann-benchmarks/bigann/base.1B.u8bin",
        "https://dl.fbaipublicfiles.com/billion-scale-ann-benchmarks/bigann/query.public.10K.u8bin",
        100_000_000,
    ),
}


def _download(url: str, tmp: str, *, rows: int = 0, itemsize: int = 0) -> str:
    """Fetch ``url`` into ``tmp``.  With ``rows``, stream only the first
    ``rows`` vectors of a big-ann binary file and rewrite the header's row
    count to match."""
    import urllib.error
    import urllib.request

    try:
        print(f"downloading {url} ...", file=sys.stderr)
        if not rows:
            urllib.request.urlretrieve(url, tmp)  # nosec - benchmark data
            return tmp
        with urllib.request.urlopen(url) as resp:  # nosec - benchmark data
            n_total, dim = (int(v) for v in np.frombuffer(resp.read(8), np.int32))
            rows = min(rows, n_total)
            remaining = rows * dim * itemsize
            with open(tmp, "wb") as fh:
                fh.write(np.asarray([rows, dim], np.int32).tobytes())
                while remaining:
                    chunk = resp.read(min(remaining, 1 << 24))
                    if not chunk:
                        raise RuntimeError(f"{url}: stream ended {remaining} bytes short")
                    fh.write(chunk)
                    remaining -= len(chunk)
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"download failed ({e}); in an offline environment use --synthetic for the "
            "deterministic stand-in with the same geometry") from e
    return tmp


def fetch(name: str, out_dir: str, *, synthetic: bool = False, scale: float = 1.0,
          k: int = 100, res: Optional[Resources] = None) -> str:
    """Fetch (or synthesize) ``name`` into ``out_dir``; returns the dataset
    directory, which ``datasets.load`` reads.  A directory that already
    holds a base file is left as it is."""
    from raft_tpu_torch.bench import datasets

    dest = os.path.join(out_dir, name)
    if any(os.path.exists(os.path.join(dest, f"base.{e}")) for e in ("fbin", "u8bin", "i8bin")):
        print(f"{dest} already present", file=sys.stderr)
        return dest
    if synthetic:
        ds = datasets.generate_groundtruth(datasets.synthetic(name, scale=scale), k=k, res=res)
        datasets.save(ds, dest)
        return dest
    os.makedirs(out_dir, exist_ok=True)
    tmps = []
    if name in _BIGANN_SOURCES:
        base_url, query_url, n_rows = _BIGANN_SOURCES[name]
        # the dtype comes from the source's extension, not the temporary's
        dtype = datasets._DTYPES[base_url.rsplit(".", 1)[-1]]
        tmps.append(_download(base_url, os.path.join(out_dir, f"{name}.base.download"),
                              rows=max(1, int(n_rows * scale)),
                              itemsize=np.dtype(dtype).itemsize))
        base = datasets.read_bin(tmps[0], dtype, mmap=True)
        tmps.append(_download(query_url, os.path.join(out_dir, f"{name}.query.download")))
        ds = datasets.Dataset(name=name, base=base, queries=datasets.read_bin(tmps[1], dtype),
                              metric="sqeuclidean")
    else:
        tmps.append(_download(_ANN_BENCHMARKS_URL.format(name=name),
                              os.path.join(out_dir, f"{name}.download")))
        ds = datasets.load_hdf5(tmps[0], name=name)
    if ds.gt_neighbors is None:
        ds = datasets.generate_groundtruth(ds, k=k, res=res)
    datasets.save(ds, dest)
    for tmp in tmps:
        os.remove(tmp)
    return dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("raft_tpu_torch.bench.get_dataset")
    ap.add_argument("--dataset", default="sift-128-euclidean")
    ap.add_argument("--out-dir", default="data")
    ap.add_argument("--synthetic", action="store_true",
                    help="write the synthetic stand-in instead of downloading")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("-k", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dest = fetch(args.dataset, args.out_dir, synthetic=args.synthetic, scale=args.scale,
                 k=args.k, res=Resources(device=args.device))
    print(dest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
