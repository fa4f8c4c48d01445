"""Nearest-neighbour indexes of the port (counterpart of ``raft_tpu.neighbors``;
sparse kNN and the kNN graph are ``raft_tpu_torch.sparse.neighbors``, as in
raft_tpu).  Random ball cover, the extras and the helpers are ROADMAP Queue 1
item 6b."""

#: raft_tpu modules the port does not serve yet, and where ROADMAP lists them
_NOT_PORTED = {
    "ball_cover": "random ball cover (ROADMAP Queue 1 item 6b)",
    "extras": "epsilon neighbourhoods and masked L2 NN (ROADMAP Queue 1 item 6b)",
    "helpers": "index helpers (ROADMAP Queue 1 item 6b)",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"neighbors.{name}: {_NOT_PORTED[name]} is not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
