"""Port parity of the search-effort specs: each backend's ``EffortSpec``
and ``neighbors.effort`` against raft_tpu's, field by field."""

import os
import dataclasses

import numpy as np
import pytest

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import effort as jeffort
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import effort as teffort
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
import torch

# six xdist workers each opening an all-core intra-op pool oversubscribe the CPU
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CPU = Resources(device="cpu")
BACKENDS = [("ivf_flat", jflat, tflat), ("ivf_pq", jpq, tpq), ("cagra", jcagra, tcagra)]
#: search params of each backend, by their knobs
PARAMS = {
    "ivf_flat": [{}, {"n_probes": 7}, {"n_probes": 1, "strategy": "query_major"}],
    "ivf_pq": [{}, {"n_probes": 64, "lut_dtype": "bfloat16"},
               {"n_probes": 3, "internal_distance_dtype": "bfloat16"}],
    "cagra": [{}, {"itopk_size": 128, "search_width": 4}, {"itopk_size": 32, "max_iterations": 9}],
}


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _same(t, j):
    assert type(t).__name__ == type(j).__name__
    assert _fields(t) == _fields(j)


@pytest.mark.parametrize("name,jmod,tmod", BACKENDS)
@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("refine_ratio", [None, 4])
def test_spec_matches_raft(name, jmod, tmod, case, refine_ratio):
    kw = PARAMS[name][case]
    extra = {} if refine_ratio is None else {"refine_ratio": refine_ratio}
    jspec = jmod.EffortSpec.from_params(jmod.SearchParams(**kw), **extra)
    tspec = tmod.EffortSpec.from_params(tmod.SearchParams(**kw), **extra)
    _same(tspec, jspec)
    assert tspec.backend == jspec.backend == name
    assert tspec.knobs() == jspec.knobs()
    _same(tspec.apply(), jspec.apply())
    _same(tspec.apply(tmod.SearchParams(**kw)), jspec.apply(jmod.SearchParams(**kw)))
    for level in range(0, 6):
        _same(tspec.degraded(level), jspec.degraded(level))
        assert tspec.degraded(level).knobs() == jspec.degraded(level).knobs()
    _same(tmod.EffortSpec.from_params(), jmod.EffortSpec.from_params())


def test_brute_force_spec_is_the_identity():
    t, j = tbf.EffortSpec.from_params(), jbf.EffortSpec.from_params()
    assert t.backend == j.backend == "brute_force"
    assert t.knobs() == j.knobs() == {}
    assert t.degraded(3) == t and t.apply("p") == "p"


def test_effort_dispatch_matches_raft():
    assert set(teffort.SPECS) == set(jeffort.SPECS)
    assert teffort.EFFORT_KNOBS == jeffort.EFFORT_KNOBS
    for name, jmod, tmod in BACKENDS:
        assert teffort.spec_class_for_params(tmod.SearchParams) is tmod.EffortSpec
        assert jeffort.spec_class_for_params(jmod.SearchParams) is jmod.EffortSpec
        for kw in PARAMS[name]:
            _same(teffort.spec_for_params(tmod.SearchParams(**kw), refine_ratio=2),
                  jeffort.spec_for_params(jmod.SearchParams(**kw), refine_ratio=2))
    assert teffort.spec_class_for_params(dict) is None and teffort.spec_for_params(3) is None


def test_spec_for_index_matches_raft():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    t_bf, j_bf = tbf.build(x, res=CPU), jbf.build(x)
    _same(teffort.spec_for_index(t_bf), jeffort.spec_for_index(j_bf))
    assert teffort.backend_for_index(t_bf) == jeffort.backend_for_index(j_bf) == "brute_force"

    class Served:   # an index carrying its search params, or a kind tag
        def __init__(self, search_params=None, kind=None):
            self.search_params, self.kind = search_params, kind

    for name, jmod, tmod in BACKENDS:
        for kw in PARAMS[name]:
            t = teffort.spec_for_index(Served(tmod.SearchParams(**kw)))
            _same(t, jeffort.spec_for_index(Served(jmod.SearchParams(**kw))))
        _same(teffort.spec_for_index(Served(kind=name)), jeffort.spec_for_index(Served(kind=name)))
        assert teffort.backend_for_index(Served(kind=name)) == name
    assert teffort.spec_for_index(object()) is None is jeffort.spec_for_index(object())
    assert teffort.backend_for_index(object()) is None
