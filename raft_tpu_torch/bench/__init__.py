"""The ANN benchmark harness of the port (counterpart of ``raft_tpu.bench``;
the reference's python/raft-ann-bench and cpp/bench/ann): datasets and
ground truth, the runner (build / search / QPS / latency / recall per
algorithm and config), the reference's configs (``conf``), result export,
the BASELINE ladder (``ladder``), primitive timings (``prims``) and the
device-time counter (``device_time``), the recall/QPS pareto filter
(``plot``; its PNG needs matplotlib) and the autotuner's frontier sweep
(``frontier``).  ``python -m raft_tpu_torch.bench`` runs a config end to
end; ``python -m raft_tpu_torch.bench frontier`` sweeps the frontier.

Not ported: ``get_dataset``'s download step (no network).
"""

from raft_tpu_torch.bench import datasets, export, runner

__all__ = ["datasets", "export", "runner"]
