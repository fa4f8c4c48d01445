"""Distributed communication facade over a mesh of torch devices
(counterpart of ``raft_tpu.comms``).

The reference's distributed backbone is ``comms_t``: a typed facade over a
transport (NCCL / UCX std_comms or MPI), injected into the resources
handle, with rank / size, comm_split, barrier and the collective verbs
(ref: cpp/include/raft/core/comms.hpp:125-232).  raft_tpu re-expresses it
as ``shard_map`` over a ``jax.sharding.Mesh``; the port keeps its verb
surface over a :class:`~raft_tpu_torch.comms.comms.Mesh` of torch devices
(several shards may share one card), with ``torch.distributed`` as the
transport across processes (:mod:`~raft_tpu_torch.comms.bootstrap`), and
runs the sharded searches, the sharded k-means iterations and the index
shards of ``serve.shard`` on it (:mod:`~raft_tpu_torch.comms.distributed`).
"""

from raft_tpu_torch.comms.comms import (
    Comms,
    make_mesh,
    local_comms,
    perform_test_comms_allreduce,
    perform_test_comms_bcast,
    perform_test_comms_allgather,
    perform_test_comms_allgatherv,
    perform_test_comms_reduce,
    perform_test_comms_reducescatter,
    perform_test_comms_send_recv,
    perform_test_comm_split,
)
from raft_tpu_torch.comms.quantized import (
    quantized_psum,
    reduce_dtype_from_env,
)
from raft_tpu_torch.comms.bootstrap import (
    CommsCluster,
    initialize,
    shutdown,
    is_initialized,
    global_mesh,
    get_raft_comm_state,
    local_handle,
    process_index,
    process_count,
)

__all__ = [
    "Comms",
    "make_mesh",
    "local_comms",
    "quantized_psum",
    "reduce_dtype_from_env",
    "CommsCluster",
    "initialize",
    "shutdown",
    "is_initialized",
    "global_mesh",
    "get_raft_comm_state",
    "local_handle",
    "process_index",
    "process_count",
    "perform_test_comms_allreduce",
    "perform_test_comms_bcast",
    "perform_test_comms_allgather",
    "perform_test_comms_allgatherv",
    "perform_test_comms_reduce",
    "perform_test_comms_reducescatter",
    "perform_test_comms_send_recv",
    "perform_test_comm_split",
]
