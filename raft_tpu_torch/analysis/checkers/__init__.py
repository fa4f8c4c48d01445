"""Checker registry: rule name → ``check(project, result)`` (counterpart
of ``raft_tpu.analysis.checkers``, without RECOMPILE: the port has no jit
to trace).

Each checker appends :class:`~raft_tpu_torch.analysis.findings.Finding`
objects to ``result.findings`` (suppressed ones to ``result.suppressed``)
and records discovery counters in ``result.stats``; the tests read those,
so a refactor that silently breaks discovery fails loudly instead of
green-lighting everything.
"""

from __future__ import annotations

from raft_tpu_torch.analysis.checkers import (
    envreg,
    hostsync,
    lockorder,
    traced,
)

CHECKERS = {
    "HOSTSYNC": hostsync.check,
    "LOCKORDER": lockorder.check,
    "ENVREG": envreg.check,
    "TRACED": traced.check,
}

__all__ = ["CHECKERS"]
