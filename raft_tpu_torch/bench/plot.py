"""Recall/QPS pareto-frontier plotting (counterpart of ``raft_tpu.bench.plot``;
the reference's raft-ann-bench plot —
throughput-vs-recall curves per algorithm, pareto-filtered)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from raft_tpu_torch.bench.runner import RunResult


def pareto_frontier(points: Sequence[Tuple[float, float]]):
    """Keep (recall, qps) points not dominated by any other (higher recall
    AND higher qps) — the reference's frontier filter."""
    pts = sorted(points, key=lambda p: (-p[0], -p[1]))
    out, best_qps = [], -1.0
    for r, q in pts:
        if q > best_qps:
            out.append((r, q))
            best_qps = q
    return list(reversed(out))


def group_frontiers(results: List[RunResult]) -> Dict[str, list]:
    by_algo = defaultdict(list)
    for r in results:
        by_algo[r.algo].append((r.recall, r.qps))
    return {a: pareto_frontier(p) for a, p in by_algo.items()}


def plot_results(results: List[RunResult], path: str, *, title: str = "") -> None:
    """Write a recall/QPS frontier PNG (matplotlib; log-scale QPS like the
    reference's plots).  Raises ``ImportError`` where matplotlib is not
    installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    for algo, pts in sorted(group_frontiers(results).items()):
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        ax.plot(xs, ys, marker="o", label=algo)
    ax.set_xlabel("Recall")
    ax.set_ylabel("QPS")
    ax.set_yscale("log")
    ax.set_title(title or (results[0].dataset if results else ""))
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
