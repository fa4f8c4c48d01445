"""Static invariant checking for the port (counterpart of
``raft_tpu.analysis``).

One :mod:`ast` pass builds a shared project model
(:mod:`raft_tpu_torch.analysis.model`) and pluggable checkers
(:mod:`raft_tpu_torch.analysis.checkers`) walk it:

========== ==============================================================
HOSTSYNC   device→host syncs reachable from the serving hot paths
LOCKORDER  lock-acquisition cycles + unguarded writes to guarded attrs
ENVREG     RAFT_TPU_* settings vs the core/env.py registry and the README's
           port table
TRACED     span coverage of the exported + serve API surface
========== ==============================================================

raft_tpu's fifth rule, RECOMPILE, reasons about ``jax.jit`` tracing; the
port has no jit, so it has no counterpart.

CLI::

    python -m raft_tpu_torch.analysis [--baseline analysis_baseline.json]

exits nonzero on any unsuppressed, unbaselined finding.  Suppress a
deliberate site inline with ``# raft-tpu: ignore[RULE]`` (comma-separate
several rules) plus a reason.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from raft_tpu_torch.analysis.findings import (
    Finding,
    load_baseline,
    write_baseline,
)
from raft_tpu_torch.analysis.model import Project

__all__ = [
    "AnalysisResult",
    "Finding",
    "Project",
    "run_analysis",
    "load_baseline",
    "write_baseline",
    "RULES",
]


def _default_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stats: Dict[str, int] = field(default_factory=dict)

    def sorted_findings(self) -> List[Finding]:
        return sorted(
            self.findings, key=lambda f: (f.path, f.line, f.rule, f.id)
        )


def RULES() -> List[str]:
    from raft_tpu_torch.analysis.checkers import CHECKERS

    return sorted(CHECKERS)


def run_analysis(
    root: Optional[str] = None,
    rules: Optional[Sequence[str]] = None,
    readme: Optional[str] = None,
) -> AnalysisResult:
    """Parse ``root`` (default: the installed raft_tpu_torch package) and
    run the selected checkers (default: all) over it."""
    from raft_tpu_torch.analysis.checkers import CHECKERS

    project = Project(root or _default_root(), readme=readme)
    selected = list(rules) if rules else sorted(CHECKERS)
    unknown = [r for r in selected if r not in CHECKERS]
    if unknown:
        raise ValueError(
            f"unknown rules {unknown}; available: {sorted(CHECKERS)}"
        )
    result = AnalysisResult()
    result.stats["modules"] = len(project.modules)
    result.stats["functions"] = len(project.functions)
    for rule in selected:
        CHECKERS[rule](project, result)
    return result
