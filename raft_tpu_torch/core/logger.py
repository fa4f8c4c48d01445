"""Framework logging (counterpart of ``raft_tpu.core.logger``): one
standard ``logging`` logger named ``raft_tpu_torch`` that the subsystems
log through, with namespaced children, and a bridge that forwards the
native core's log records into it (:func:`bridge_native`).
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


#: native levels (cpp/include/raft_tpu/core/logger.hpp) → logging levels
_NATIVE_TO_PY = {
    0: logging.CRITICAL,  # off: nothing should arrive, map high
    1: logging.CRITICAL,
    2: logging.ERROR,
    3: logging.WARNING,
    4: logging.INFO,
    5: logging.DEBUG,
    6: logging.DEBUG,  # trace
}

_bridged = False


def bridge_native() -> bool:
    """Route the native core's log records (``core.native``, ``cpp/``)
    into the ``raft_tpu_torch`` logger.  Returns False where the native
    core is unavailable.  Idempotent."""
    global _bridged
    if _bridged:
        return True
    from raft_tpu_torch.core import native

    if not native.available():
        return False
    native.log_set_callback(
        lambda lvl, msg: logger.log(_NATIVE_TO_PY.get(lvl, logging.INFO), "%s", msg))
    _bridged = True
    return True
