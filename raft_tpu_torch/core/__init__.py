"""Core: resources, validation, serialization, the bitset and the batch
fan-out (counterpart of ``raft_tpu.core``)."""

from raft_tpu_torch.core import serialize
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.fanout import async_fanout, prefetch_to_device, row_batches
from raft_tpu_torch.core.resources import (
    DeviceResources,
    Resources,
    default_resources,
    set_default_resources,
)
from raft_tpu_torch.core.validation import LogicError, RaftError, expects, fail

__all__ = [
    "Resources",
    "DeviceResources",
    "default_resources",
    "set_default_resources",
    "Bitset",
    "serialize",
    "RaftError",
    "LogicError",
    "expects",
    "fail",
    "async_fanout",
    "prefetch_to_device",
    "row_batches",
]
