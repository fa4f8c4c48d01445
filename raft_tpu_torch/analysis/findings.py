"""Findings: the unit of output every checker produces (counterpart of
``raft_tpu.analysis.findings``).

A finding's identity is content-addressed — rule, file, symbol and
message, but **not** the line number — so IDs survive unrelated edits
to the same file (a baseline pinned to line numbers would churn on
every reflow).  Two findings with the same rule/file/symbol/message
are the same finding.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Set

BASELINE_VERSION = 1


def _digest(rule: str, path: str, symbol: str, message: str) -> str:
    h = hashlib.sha1(f"{rule}|{path}|{symbol}|{message}".encode())
    return h.hexdigest()[:8]


@dataclass(frozen=True)
class Finding:
    """One invariant violation at a concrete site."""

    rule: str      # HOSTSYNC / LOCKORDER / ENVREG / TRACED
    path: str      # file path relative to the scan root's parent
    line: int      # 1-based; for display only, not part of the ID
    symbol: str    # dotted qualname (or var name) the finding anchors to
    message: str
    id: str = field(init=False)

    def __post_init__(self):
        object.__setattr__(
            self, "id", _digest(self.rule, self.path, self.symbol, self.message)
        )

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule}[{self.id}] "
            f"{self.symbol}: {self.message}"
        )

    def to_dict(self) -> Dict[str, object]:
        return {
            "id": self.id,
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
        }


def load_baseline(path: str) -> Set[str]:
    """The set of accepted finding IDs recorded in a baseline file."""
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}, "
            f"expected {BASELINE_VERSION}"
        )
    return {str(i) for i in data.get("ids", [])}


def write_baseline(path: str, findings: List[Finding]) -> None:
    """Record the current unsuppressed findings as the accepted set."""
    data = {
        "version": BASELINE_VERSION,
        "ids": sorted(f.id for f in findings),
        # context only — the IDs above are what filtering reads
        "findings": [f.to_dict() for f in sorted(
            findings, key=lambda f: (f.path, f.line, f.rule))],
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")
