"""raft_tpu_torch.serve — online ANN query serving on one device
(counterpart of ``raft_tpu.serve``).

- :mod:`~raft_tpu_torch.serve.batcher` — dynamic micro-batching into a
  padded power-of-two bucket ladder, warmed before traffic; on the card
  each batcher owns a CUDA stream, pinned staging buffers and one event a
  batch (pipelined dispatch).
- :mod:`~raft_tpu_torch.serve.mutation` — ``MutableIndex``: tombstone
  deletes filtered inside the backend searches + a brute-force side buffer
  for upserts, merged through one ``select_k``.
- :mod:`~raft_tpu_torch.serve.registry` — named, versioned indexes with
  atomic hot-swap and snapshot / restore.
- :mod:`~raft_tpu_torch.serve.metrics` — QPS / p50 / p99 / batch fill, the
  stage breakdown, and the count of kernel builds on the dispatch thread.
- :mod:`~raft_tpu_torch.serve.compactor` — background shadow rebuilds that
  fold tombstones and the side buffer back into the main structure.
- :mod:`~raft_tpu_torch.serve.ragged` — ragged batching: per-request k and
  registered filter ids as descriptor data.
- :mod:`~raft_tpu_torch.serve.overload` — priorities, deadlines, admission
  control and degraded-mode search; :mod:`~raft_tpu_torch.serve.effort`
  arbitrates the effort level.

``SearchService`` (:mod:`~raft_tpu_torch.serve.service`) assembles them.
Multi-GPU serving (``ShardedIndex``, ``ReplicaGroup``, ``build_sharded``,
``HedgedDispatcher``'s replicas) is ROADMAP Queue 1 item 7: those names
raise ``NotImplementedError``.
"""

from raft_tpu_torch.serve.batcher import MicroBatcher
from raft_tpu_torch.serve.compactor import CompactionPolicy, Compactor
from raft_tpu_torch.serve.effort import EffortArbiter
from raft_tpu_torch.serve.metrics import (
    ServingMetrics,
    compile_count,
    install_compile_listener,
)
from raft_tpu_torch.serve.mutation import MutableIndex
from raft_tpu_torch.serve.overload import (
    AdmissionController,
    DeadlineExceeded,
    DegradedModeManager,
    HedgedDispatcher,
    OverloadConfig,
    Shed,
)
from raft_tpu_torch.serve.ragged import FilterRegistry, RaggedSearcher, RaggedSpec
from raft_tpu_torch.serve.registry import IndexRegistry
from raft_tpu_torch.serve.service import SearchService

#: raft_tpu.serve names of multi-GPU serving (ROADMAP Queue 1 item 7)
_MULTI_GPU = frozenset({
    "ReplicaGroup", "ShardedIndex", "build_sharded", "knn_graph_sharded",
    "make_replicated_search", "replicated_search", "shard_index",
})


def __getattr__(name):
    if name in _MULTI_GPU:
        raise NotImplementedError(
            f"serve.{name} is multi-GPU serving, not ported yet (ROADMAP Queue 1 item 7)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionController",
    "CompactionPolicy",
    "Compactor",
    "DeadlineExceeded",
    "DegradedModeManager",
    "EffortArbiter",
    "FilterRegistry",
    "HedgedDispatcher",
    "IndexRegistry",
    "MicroBatcher",
    "MutableIndex",
    "OverloadConfig",
    "RaggedSearcher",
    "RaggedSpec",
    "SearchService",
    "ServingMetrics",
    "Shed",
    "compile_count",
    "install_compile_listener",
]
