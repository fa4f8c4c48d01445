"""Framework logging (counterpart of ``raft_tpu.core.logger``): one
standard ``logging`` logger named ``raft_tpu_torch`` that the subsystems
log through, with namespaced children.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("raft_tpu_torch")


def child(name: str) -> logging.Logger:
    """Namespaced sub-logger (``raft_tpu_torch.<name>``): handlers and
    levels set on ``raft_tpu_torch`` reach every subsystem, and a child
    (the slow-query log's ``obs.slowlog``) can be routed or silenced on its
    own."""
    return logger.getChild(name)


def get_logger() -> logging.Logger:
    return logger


def bridge_native() -> bool:
    """raft_tpu routes the log records of its native C++ core
    (``core.native``, ``cpp/``) into its logger.  The port does not bind
    that library yet (ROADMAP Queue 1 item 6b), so there is nothing to
    bridge: returns False, as raft_tpu does where no native toolchain is
    available."""
    return False
