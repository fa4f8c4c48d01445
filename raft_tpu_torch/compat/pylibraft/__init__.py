"""Drop-in pylibraft namespace (counterpart of ``raft_tpu.compat.pylibraft``)."""

from raft_tpu_torch.compat.pylibraft import (
    cluster,
    common,
    config,
    distance,
    matrix,
    neighbors,
    random,
)

__all__ = [
    "cluster", "common", "config", "distance", "matrix", "neighbors", "random",
]
