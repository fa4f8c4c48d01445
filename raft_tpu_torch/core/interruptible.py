"""Cooperative cross-thread cancellation (counterpart of
``raft_tpu.core.interruptible``; the reference's ``interruptible.hpp`` and
pylibraft's ``common/interruptible.pyx``).

A wait on the card cannot be interrupted midway, so the cancellation
points are the synchronisations themselves: ``Resources.sync`` calls
:func:`check` before and after it blocks, and raises ``InterruptedError``
when another thread cancelled this one.  Tokens are per thread; a failed
check clears the flag (the reference's rule); the tokens of dead threads
are pruned, so a recycled thread id inherits nothing.  A thread's own
token lives in the native core (``core.native``) where it is available.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class _PyToken:
    def __init__(self):
        self._flag = threading.Event()

    def cancel(self) -> None:
        self._flag.set()

    @property
    def cancelled(self) -> bool:
        return self._flag.is_set()

    def check(self) -> None:
        if self._flag.is_set():
            self._flag.clear()
            raise InterruptedError("interruptible: cancelled")


_tokens: Dict[int, object] = {}
_lock = threading.Lock()


def get_token(thread_id: Optional[int] = None):
    """This thread's (or another one's) cancellation token."""
    tid = thread_id if thread_id is not None else threading.get_ident()
    with _lock:
        tok = _tokens.get(tid)
        if tok is None:
            from raft_tpu_torch.core import native

            if thread_id is None and native.available():
                tok = native.InterruptibleToken()
            else:
                tok = _PyToken()
            _tokens[tid] = tok
        return tok


def cancel(thread_id: int) -> None:
    """Cancel another thread's next synchronisation."""
    live = {t.ident for t in threading.enumerate()}
    with _lock:
        for tid in [t for t in _tokens if t not in live]:
            del _tokens[tid]
    get_token(thread_id).cancel()


def check() -> None:
    """Raise InterruptedError if this thread was cancelled (and clear the
    flag); a no-op otherwise."""
    tid = threading.get_ident()
    with _lock:
        tok = _tokens.get(tid)
    if tok is not None:
        try:
            tok.check()
        except InterruptedError:
            # consumed: a thread that later recycles this id starts clean
            with _lock:
                _tokens.pop(tid, None)
            raise
