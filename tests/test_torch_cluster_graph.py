"""Port parity: single-linkage clustering (``raft_tpu_torch.cluster.
single_linkage``) and the label utilities (``raft_tpu_torch.label``) against
raft_tpu's, case by case after raft_tpu's ``tests/test_cluster_graph.py``,
on the same seeded numpy inputs.

Blobs are rounded to a 1/16 grid, so that every squared L2 distance
(|x|^2 + |y|^2 - 2 x.y in f32) is exact in both packages whatever the
summation order: the kNN graphs hold the same edges (checked first) and
labels, dendrogram, merge distances and sizes are equal.  (Off the grid,
two merges whose distances differ by less than the f32 cancellation error,
~1e-4 at |x|^2 ~ 10^2, can swap places.)  Label utilities are exact."""

import os

import jax
import numpy as np
import pytest
import torch

from raft_tpu.cluster import single_linkage as jsingle_linkage
from raft_tpu.label import get_classlabels as jget, make_monotonic as jmono
from raft_tpu.label import merge_labels as jmerge, relabel as jrelabel
from raft_tpu.random import make_blobs as jmake_blobs
from raft_tpu.sparse.neighbors import knn_graph as jknn_graph
from raft_tpu_torch.cluster import single_linkage as tsingle_linkage
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.label import get_classlabels, make_monotonic, merge_labels, relabel
from raft_tpu_torch.sparse.neighbors import knn_graph as tknn_graph
from raft_tpu_torch.stats import adjusted_rand_index

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _edges(g):
    r = np.asarray(g.rows)[:g.nnz]
    c = np.asarray(g.cols)[:g.nnz]
    return set(zip(r.tolist(), c.tolist()))


@pytest.mark.parametrize("n,d,k,std,c,n_clusters", [(300, 8, 3, 0.5, 10, 3),
                                                    (240, 4, 4, 0.3, 6, 4)])
def test_single_linkage_matches_raft_tpu_on_exact_blobs(n, d, k, std, c, n_clusters):
    x, truth, _ = jmake_blobs(jax.random.PRNGKey(0), n, d, n_clusters=k, cluster_std=std)
    x, truth = (np.round(np.asarray(x) * 16) / 16).astype(np.float32), np.asarray(truth)
    assert _edges(jknn_graph(x, c)) == _edges(tknn_graph(x, c, res=CPU))   # no ties
    jo = jsingle_linkage(x, n_clusters=n_clusters, c=c)
    to = tsingle_linkage(x, n_clusters=n_clusters, c=c, res=CPU)
    np.testing.assert_array_equal(to.labels.numpy(), np.asarray(jo.labels))
    np.testing.assert_array_equal(to.dendrogram, jo.dendrogram)
    np.testing.assert_array_equal(to.sizes, jo.sizes)
    np.testing.assert_array_equal(to.deltas, jo.deltas)
    assert to.n_clusters == n_clusters
    ari = float(adjusted_rand_index(to.labels.numpy(), truth, res=CPU))
    assert ari > 0.95


def test_single_linkage_against_scipy():
    from scipy.cluster.hierarchy import fcluster, linkage

    x = np.random.default_rng(1).random((80, 4))
    out = tsingle_linkage(x.astype(np.float32), n_clusters=4, c=20, metric="euclidean", res=CPU)
    ref = fcluster(linkage(x, method="single", metric="euclidean"), 4, "maxclust")
    assert float(adjusted_rand_index(out.labels.numpy(), ref - 1, res=CPU)) > 0.9
    assert (np.diff(out.deltas) >= -1e-6).all()


def test_single_linkage_connects_components_and_shapes():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.random((25, 3)) + 20.0 * g for g in range(3)]).astype(np.float32)
    out = tsingle_linkage(x, n_clusters=2, c=4, res=CPU)   # the kNN graph has 3 components
    assert out.dendrogram.shape == (74, 2) and out.sizes[-1] == 75
    jo = jsingle_linkage(x, n_clusters=2, c=4)
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(jo.labels))
    with pytest.raises(ValueError):
        tsingle_linkage(x, n_clusters=0, res=CPU)


def test_classlabels():
    labels = np.array([5, 3, 5, 9, 3, 3], np.int32)
    np.testing.assert_array_equal(get_classlabels(labels, res=CPU).numpy(), np.asarray(jget(labels)))
    np.testing.assert_array_equal(make_monotonic(labels, res=CPU).numpy(),
                                  np.asarray(jmono(labels)))
    classes = np.array([1, 3, 5, 7, 9], np.int32)
    np.testing.assert_array_equal(make_monotonic(labels, classes=classes, res=CPU).numpy(),
                                  np.asarray(jmono(labels, classes=classes)))
    old, new = np.array([5, 9]), np.array([50, 90])
    np.testing.assert_array_equal(relabel(labels, old, new, res=CPU).numpy(),
                                  np.asarray(jrelabel(labels, old, new)))


@pytest.mark.parametrize("a,b,mask", [
    ([0, 0, 2, 2, 4, 4], [7, 1, 1, 8, 9, 9], [False, True, True, False, False, False]),
    (list(range(6)), [0, 0, 0, 7, 9, 9], [False, False, False, True, True, False]),
    (list(range(6)), [0, 0, 0, 7, 9, 9], [False, False, False, False, True, True]),
    ([1, 1, 3, 3], [0, 2, 0, 2], [False] * 4),
])
def test_merge_labels_cases(a, b, mask):
    a, b, mask = np.asarray(a, np.int32), np.asarray(b, np.int32), np.asarray(mask)
    np.testing.assert_array_equal(merge_labels(a, b, mask, res=CPU).numpy(),
                                  np.asarray(jmerge(a, b, mask)))


def test_merge_labels_random():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 40, 300).astype(np.int32)
    b = rng.integers(0, 400, 300).astype(np.int32)
    mask = rng.random(300) < 0.3
    np.testing.assert_array_equal(merge_labels(torch.from_numpy(a), torch.from_numpy(b),
                                               torch.from_numpy(mask)).numpy(),
                                  np.asarray(jmerge(a, b, mask)))
