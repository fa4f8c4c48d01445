"""The ANN benchmark harness of the port (counterpart of ``raft_tpu.bench``;
the reference's python/raft-ann-bench and cpp/bench/ann): datasets and
ground truth, the runner (build / search / QPS / latency / recall per
algorithm and config), the reference's configs (``conf``), result export,
the BASELINE ladder (``ladder``), primitive timings (``prims``) and the
device-time counter (``device_time``).  ``python -m raft_tpu_torch.bench``
runs a config end to end.

Not ported: ``plot`` (no matplotlib where the card is), ``frontier`` (it
comes with the autotuner, ROADMAP Queue 1 item 5b) and ``get_dataset``'s
download step (no network).
"""

from raft_tpu_torch.bench import datasets, export, runner

__all__ = ["datasets", "export", "runner"]
