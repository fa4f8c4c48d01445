"""Nearest-neighbour indexes of the port (counterpart of ``raft_tpu.neighbors``)."""

#: raft_tpu modules the port does not serve yet, and where ROADMAP lists them
_NOT_PORTED = {
    "ball_cover": "random ball cover (ROADMAP Queue 1 item 6)",
    "extras": "epsilon neighbourhoods and masked L2 NN (ROADMAP Queue 1 item 6)",
    "helpers": "index helpers (ROADMAP Queue 1 item 6)",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"neighbors.{name}: {_NOT_PORTED[name]} is not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
