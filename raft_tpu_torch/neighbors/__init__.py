"""Nearest-neighbour indexes of the port (counterpart of ``raft_tpu.neighbors``)."""

#: raft_tpu modules the port does not serve yet, and where ROADMAP lists them
_NOT_PORTED = {
    "hnsw": "hnsw export and search of CAGRA graphs (ROADMAP Queue 2, CAGRA leftovers)",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"neighbors.{name}: {_NOT_PORTED[name]} is not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
