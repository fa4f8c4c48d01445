"""Core: resources, validation, serialization and the bitset (counterpart
of ``raft_tpu.core``; ``core.fanout`` is ROADMAP Queue 1 item 6b)."""

from raft_tpu_torch.core import serialize
from raft_tpu_torch.core.bitset import Bitset
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
]
